"""K1: the fused IDEALEM encode step, scanned over a whole feed.

``csrc/encode_step.cu`` replaces the TPU kernel
``repro/kernels/encode_step.py::encode_step_pallas``, its mixed-mode
``chan`` operand included.  Per block it applies the min/max gate
(eq. 3), in the error-bounded mode the pointwise error gate on the raw
rows (on their running sum when ``error_cumulative``), the KS distance
(eq. 1) on the rows that pass both, picks the lowest passing row, decides
hit/slot/overwrite and inserts the sorted block (and its raw row) at
``count % D`` on a miss.  The CUDA kernel keeps one channel's dictionary
resident in one CTA and walks all of the feed's blocks there, so a feed of
C channels is one launch.

:func:`encode_scan` launches the kernel for CUDA tensors and runs the plain
version, :func:`encode_scan_torch`, for CPU tensors.  The plain version
repeats the kernel's arithmetic: ECDF counts from broadcast compares and
gaps scaled by ``inv_n = f32(1/n)``, as the TPU kernel computes them
(:func:`repro_torch.kernels.ref.ks_counts`; the reference matcher divides
by n instead, and both decide alike because ``critical_distance`` never
sits on a multiple of 1/n), and the error gate in float32 with the running
sum added left to right.

``chan`` (C, 8) float32 gives each channel its own parameters, as the TPU
kernel's operand of the same name does for adaptive cohorts (layout
``CHAN_*``): the logical width ``nf`` <= n (the columns past it are
``+inf`` pads), ``inv_n = f32(1/nf)``, d_crit, the cumulative error metric
and whether the error gate is armed.  The min/max gate and the stored
maximum take ``x[nf - 1]``, the error gate the first ``nf`` columns, and the
KS counts run over all n columns with the gaps of the first ``nf`` points.
"""
from __future__ import annotations

import ctypes
import sys
from typing import Optional

import numpy as np
import torch

from ..core.encoder import DictState, _decide, _empty_decisions
from ..errors import KernelShapeError
from . import _build
from .ref import error_gate, ks_counts, minmax_gate

__all__ = ["encode_scan", "encode_scan_torch", "encode_step_torch",
           "dict_in_smem", "launches", "MAX_DICT", "CHAN_NF", "CHAN_INV_N",
           "CHAN_DCRIT", "CHAN_ERRCUM", "CHAN_EBON"]

#: Kernel launches since import (or since a caller reset it to 0).
launches = 0

#: One thread per dictionary row in a 256-thread CTA.
MAX_DICT = 256

#: Columns of the (C, 8) float32 ``chan`` operand (5..7 are padding).
CHAN_NF, CHAN_INV_N, CHAN_DCRIT, CHAN_ERRCUM, CHAN_EBON = range(5)


def _f32(v: float) -> float:
    return float(np.float32(v))


def encode_step_torch(xs, valid, state: DictState, *, d_crit: float,
                      rel_tol: float, use_minmax: bool = True,
                      use_ks: bool = True, raw=None,
                      error_bound: Optional[float] = None,
                      error_cumulative: bool = False, chan=None):
    """Plain version of one step for C channels: sorted f32 candidates
    ``xs`` (C, n), block mask ``valid`` (C,) and, with ``error_bound``,
    the raw rows ``raw`` (C, n); ``chan`` as :func:`encode_scan`.  Returns
    ``(new_state, (is_hit, slot, overwrite))``."""
    n = xs.shape[-1]
    cols = xmax = None
    inv_n = _f32(1.0 / n)
    thresh = torch.tensor(_f32(d_crit), dtype=torch.float32)
    cumulative, armed = error_cumulative, None
    if chan is not None:
        nf = chan[:, CHAN_NF].long()
        cols = torch.arange(n, device=xs.device) < nf[:, None]
        xmax = torch.gather(xs, 1, nf[:, None] - 1)
        inv_n, thresh = chan[:, CHAN_INV_N], chan[:, CHAN_DCRIT, None]
        cumulative = chan[:, CHAN_ERRCUM] != 0
        armed = chan[:, CHAN_EBON, None] != 0
    gate = state.valid
    if use_minmax:
        r = torch.tensor(_f32(rel_tol), dtype=torch.float32)
        gate = gate & minmax_gate(xs[:, :1], xs[:, -1:] if xmax is None
                                  else xmax, state.dmin, state.dmax, r)
    if error_bound is not None:
        ok = error_gate(raw, state.raw_blocks, error_bound, cumulative, cols)
        gate = gate & (ok if armed is None else ok | ~armed)
    if use_ks:
        ks = ks_counts(xs, state.sorted_blocks, inv_n, cols)
        gate = gate & (ks <= thresh)
    return _decide(state, xs, gate, valid,
                   None if error_bound is None else raw, xmax)


def encode_scan_torch(xs, valid, state: DictState, *, raw=None, **params):
    """Plain version of the whole scan: ``xs`` (C, nb, n) sorted f32,
    ``valid`` (C, nb), ``raw`` (C, nb, n) with ``error_bound``.  Returns
    ``((is_hit, slot, overwrite), new_state)`` with (C, nb) decisions;
    ``params`` as :func:`encode_step_torch`."""
    C, nb, _ = xs.shape
    out = ([], [], [])
    for b in range(nb):
        state, dec = encode_step_torch(
            xs[:, b], valid[:, b], state,
            raw=None if raw is None else raw[:, b], **params)
        for acc, v in zip(out, dec):
            acc.append(v)
    if nb == 0:
        return _empty_decisions(C, xs.device), state
    return tuple(torch.stack(v, dim=1) for v in out), state


def _check(xs, valid, state: DictState, raw, eb: bool, chan):
    if xs.dim() != 3 or xs.dtype != torch.float32:
        raise KernelShapeError(
            f"encode_scan: xs must be (C, nb, n) float32, got "
            f"{tuple(xs.shape)} {xs.dtype}")
    C, nb, n = xs.shape
    D = state.sorted_blocks.shape[-2]
    want = {
        "valid": (valid, (C, nb), torch.bool),
        "sorted_blocks": (state.sorted_blocks, (C, D, n), torch.float32),
        "dmin": (state.dmin, (C, D), torch.float32),
        "dmax": (state.dmax, (C, D), torch.float32),
        "state.valid": (state.valid, (C, D), torch.bool),
        "count": (state.count, (C,), torch.int32),
    }
    if eb:
        want["raw"] = (raw, (C, nb, n), torch.float32)
        want["raw_blocks"] = (state.raw_blocks, (C, D, n), torch.float32)
    if chan is not None:
        want["chan"] = (chan, (C, 8), torch.float32)
    for name, (t, shape, dtype) in want.items():
        if t is None or tuple(t.shape) != shape or t.dtype != dtype:
            got = None if t is None else (tuple(t.shape), t.dtype)
            raise KernelShapeError(
                f"encode_scan: {name} must be {shape} {dtype}, got {got}")
        if t.device != xs.device:
            raise KernelShapeError(
                f"encode_scan: {name} on {t.device}, xs on {xs.device}")
    if not 1 <= D <= MAX_DICT:
        raise KernelShapeError(f"encode_scan: D={D} outside [1, {MAX_DICT}]")
    if n < 1 or C * nb * n >= 2 ** 31 or C * D * n >= 2 ** 31:
        raise KernelShapeError(f"encode_scan: shape (C={C}, nb={nb}, n={n}, "
                               f"D={D}) outside the kernel's int32 range")
    if chan is not None:
        nf = chan[:, CHAN_NF]
        if not bool(((nf >= 1) & (nf <= n) & (nf == nf.round())).all()):
            raise KernelShapeError(
                f"encode_scan: chan widths must be integers in [1, n={n}]")


def dict_in_smem(n: int, D: int, error_bound: bool,
                 chan: bool = False) -> bool:
    """Whether the kernel keeps a (D, n) dictionary -- with
    ``error_bound``, and its raw rows -- in shared memory on the current
    card (else in the carry-out buffers in global memory); ``chan``: for
    a launch with the chan operand."""
    fn = _build.load("encode_step").encode_scan_dict_in_smem
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return bool(fn(n, D, int(bool(error_bound)), int(bool(chan))))


def encode_scan(xs, valid, state: DictState, *, d_crit: float,
                rel_tol: float, use_minmax: bool = True, use_ks: bool = True,
                raw=None, error_bound: Optional[float] = None,
                error_cumulative: bool = False, chan=None):
    """Run the encode scan over a feed: ``xs`` (C, nb, n) float32 blocks
    sorted along the last axis, ``valid`` (C, nb) bool, ``state`` the
    (C, D, ...) carry.  With ``error_bound``, ``raw`` (C, nb, n) holds the
    blocks in stream order and the carry its raw rows (C, D, n).  With
    ``chan`` (C, 8) float32 (module docstring) each channel takes its
    width, d_crit, error metric and gate from its row, and ``d_crit`` and
    ``error_cumulative`` are not read.  Returns
    ``((is_hit, slot, overwrite), new_state)``; the input state is not
    modified.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream or raise (:class:`KernelShapeError` for operands the
    kernel does not take, ``RuntimeError`` for a failed launch).
    """
    params = dict(d_crit=d_crit, rel_tol=rel_tol, use_minmax=use_minmax,
                  use_ks=use_ks, error_bound=error_bound,
                  error_cumulative=error_cumulative, chan=chan)
    eb = error_bound is not None
    if xs.device.type == "cpu":
        return encode_scan_torch(xs, valid, state, raw=raw if eb else None,
                                 **params)
    if xs.device.type != "cuda":
        raise KernelShapeError(f"encode_scan: unsupported device {xs.device}")
    _check(xs, valid, state, raw, eb, chan)
    C, nb, n = xs.shape
    D = state.sorted_blocks.shape[-2]
    xs, valid = xs.contiguous(), valid.contiguous()
    sin = DictState(*(f.contiguous() for f in state))
    # without the bound the raw rows pass through untouched
    sout = DictState(*(torch.empty_like(f) for f in sin[:5]),
                     torch.empty_like(sin.raw_blocks) if eb
                     else sin.raw_blocks)
    is_hit = torch.empty((C, nb), dtype=torch.bool, device=xs.device)
    slot = torch.empty((C, nb), dtype=torch.int32, device=xs.device)
    overwrite = torch.empty((C, nb), dtype=torch.bool, device=xs.device)
    if C == 0 or nb == 0:
        return (is_hit, slot, overwrite), DictState(
            *(f.clone() for f in sin[:5]), sin.raw_blocks)
    raw = raw.contiguous() if eb else None
    raw_ptrs = ((raw.data_ptr(), sin.raw_blocks.data_ptr(),
                 sout.raw_blocks.data_ptr()) if eb else (None, None, None))
    if chan is not None:
        chan = chan.contiguous()
    chan_ptr = None if chan is None else chan.data_ptr()
    fn = _build.load("encode_step").encode_scan_f32
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 4 \
        + [ctypes.c_float] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    ptrs = [t.data_ptr() for t in (xs, valid, *sin[:5], *sout[:5], is_hit,
                                   slot, overwrite)]
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = fn(*ptrs, *raw_ptrs, C, nb, n, D, _f32(d_crit), _f32(rel_tol),
                _f32(1.0 / n), _f32(error_bound) if eb else 0.0,
                int(bool(use_minmax)), int(bool(use_ks)), int(eb),
                int(bool(error_cumulative)), chan_ptr, stream)
    if rc != 0:
        raise RuntimeError(f"encode_scan kernel launch failed: CUDA error {rc}")
    _build.count_launch(sys.modules[__name__])
    return (is_hit, slot, overwrite), sout
