"""K1: the fused IDEALEM encode step, scanned over a whole feed.

``csrc/encode_step.cu`` replaces the TPU kernel
``repro/kernels/encode_step.py::encode_step_pallas`` (without its
error-bound ``raw`` and mixed-mode ``chan`` operands).  Per block it applies
the min/max gate (eq. 3), the KS distance (eq. 1) on the rows that pass the
gate, picks the lowest passing row, decides hit/slot/overwrite and inserts
the sorted block at ``count % D`` on a miss.  The CUDA kernel keeps one
channel's dictionary resident in one CTA and walks all of the feed's blocks
there, so a feed of C channels is one launch.

:func:`encode_scan` launches the kernel for CUDA tensors and runs the plain
version, :func:`encode_scan_torch`, for CPU tensors.  The plain version
repeats the kernel's arithmetic: ECDF counts from broadcast compares and
gaps scaled by ``inv_n = f32(1/n)``, as the TPU kernel computes them (the
reference matcher divides by n instead; both decide alike because
``critical_distance`` never sits on a multiple of 1/n).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.encoder import DictState, _decide, _minmax_gate
from ..errors import KernelShapeError
from . import _build

__all__ = ["encode_scan", "encode_scan_torch", "encode_step_torch",
           "launches", "MAX_DICT"]

#: Kernel launches since import (or since a caller reset it to 0).
launches = 0

#: One thread per dictionary row in a 256-thread CTA.
MAX_DICT = 256


def _f32(v: float) -> float:
    return float(np.float32(v))


def ks_fused_torch(xs: torch.Tensor, ds: torch.Tensor,
                   inv_n: float) -> torch.Tensor:
    """KS distance with the kernel's arithmetic: ``xs`` (C, n) sorted
    candidates, ``ds`` (C, D, n) sorted rows -> (C, D) float32."""
    n = xs.shape[-1]
    f32 = torch.float32
    inv = torch.tensor(inv_n, dtype=f32, device=xs.device)
    x = xs[:, None, None, :]                      # (C, 1, 1, n_j)
    d_k = ds[:, :, :, None]                       # (C, D, n_k, 1)
    cnt_d = (d_k <= x).sum(2).to(f32)             # (C, D, n_j): #{d <= x_j}
    f_x = (torch.arange(n, dtype=f32, device=xs.device) + 1.0) * inv
    d1 = torch.abs(f_x - cnt_d * inv).amax(-1)
    cnt_x = (x <= d_k).sum(3).to(f32)             # (C, D, n_k): #{x <= d_k}
    rank_d = (ds[:, :, None, :] <= d_k).sum(3).to(f32)  # #{d <= d_k}
    d2 = torch.abs(cnt_x * inv - rank_d * inv).amax(-1)
    return torch.maximum(d1, d2)


def encode_step_torch(xs, valid, state: DictState, *, d_crit: float,
                      rel_tol: float, use_minmax: bool = True,
                      use_ks: bool = True):
    """Plain version of one step for C channels: sorted f32 candidates
    ``xs`` (C, n), block mask ``valid`` (C,).  Returns
    ``(new_state, (is_hit, slot, overwrite))``."""
    gate = state.valid
    if use_minmax:
        r = torch.tensor(_f32(rel_tol), dtype=torch.float32, device=xs.device)
        gate = gate & _minmax_gate(xs[:, :1], xs[:, -1:], state.dmin,
                                   state.dmax, r)
    if use_ks:
        ks = ks_fused_torch(xs, state.sorted_blocks, _f32(1.0 / xs.shape[-1]))
        gate = gate & (ks <= torch.tensor(_f32(d_crit), dtype=torch.float32,
                                          device=xs.device))
    return _decide(state, xs, gate, valid)


def encode_scan_torch(xs, valid, state: DictState, **params):
    """Plain version of the whole scan: ``xs`` (C, nb, n) sorted f32,
    ``valid`` (C, nb).  Returns ``((is_hit, slot, overwrite), new_state)``
    with (C, nb) decisions; ``params`` as :func:`encode_step_torch`."""
    C, nb, _ = xs.shape
    out = ([], [], [])
    for b in range(nb):
        state, dec = encode_step_torch(xs[:, b], valid[:, b], state, **params)
        for acc, v in zip(out, dec):
            acc.append(v)
    if nb == 0:
        dev = xs.device
        return ((torch.zeros((C, 0), dtype=torch.bool, device=dev),
                 torch.zeros((C, 0), dtype=torch.int32, device=dev),
                 torch.zeros((C, 0), dtype=torch.bool, device=dev)), state)
    return tuple(torch.stack(v, dim=1) for v in out), state


def _check(xs, valid, state: DictState):
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
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise KernelShapeError(
                f"encode_scan: {name} must be {shape} {dtype}, got "
                f"{tuple(t.shape)} {t.dtype}")
        if t.device != xs.device:
            raise KernelShapeError(
                f"encode_scan: {name} on {t.device}, xs on {xs.device}")
    if not 1 <= D <= MAX_DICT:
        raise KernelShapeError(f"encode_scan: D={D} outside [1, {MAX_DICT}]")
    if n < 1 or C * nb * n >= 2 ** 31 or C * D * n >= 2 ** 31:
        raise KernelShapeError(f"encode_scan: shape (C={C}, nb={nb}, n={n}, "
                               f"D={D}) outside the kernel's int32 range")


def encode_scan(xs, valid, state: DictState, *, d_crit: float,
                rel_tol: float, use_minmax: bool = True, use_ks: bool = True):
    """Run the encode scan over a feed: ``xs`` (C, nb, n) float32 blocks
    sorted along the last axis, ``valid`` (C, nb) bool, ``state`` the
    (C, D, ...) carry.  Returns ``((is_hit, slot, overwrite), new_state)``;
    the input state is not modified.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream or raise (:class:`KernelShapeError` for operands the
    kernel does not take, ``RuntimeError`` for a failed launch).
    """
    params = dict(d_crit=d_crit, rel_tol=rel_tol, use_minmax=use_minmax,
                  use_ks=use_ks)
    if xs.device.type == "cpu":
        return encode_scan_torch(xs, valid, state, **params)
    if xs.device.type != "cuda":
        raise KernelShapeError(f"encode_scan: unsupported device {xs.device}")
    _check(xs, valid, state)
    C, nb, n = xs.shape
    D = state.sorted_blocks.shape[-2]
    xs, valid = xs.contiguous(), valid.contiguous()
    sin = DictState(*(f.contiguous() for f in state))
    sout = DictState(*(torch.empty_like(f) for f in sin))
    is_hit = torch.empty((C, nb), dtype=torch.bool, device=xs.device)
    slot = torch.empty((C, nb), dtype=torch.int32, device=xs.device)
    overwrite = torch.empty((C, nb), dtype=torch.bool, device=xs.device)
    if C == 0 or nb == 0:
        return (is_hit, slot, overwrite), DictState(*(f.clone() for f in sin))
    fn = _build.load("encode_step").encode_scan_f32
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 \
        + [ctypes.c_float] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = [t.data_ptr() for t in (xs, valid, *sin, *sout, is_hit, slot,
                                   overwrite)]
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = fn(*ptrs, C, nb, n, D, _f32(d_crit), _f32(rel_tol),
                _f32(1.0 / n), int(bool(use_minmax)), int(bool(use_ks)),
                stream)
    if rc != 0:
        raise RuntimeError(f"encode_scan kernel launch failed: CUDA error {rc}")
    global launches
    launches += 1
    return (is_hit, slot, overwrite), sout
