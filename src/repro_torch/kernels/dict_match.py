"""K3: the KS distance and eq. 3 gate of a block against the dictionary.

``csrc/dict_match.cu`` replaces the TPU kernel
``repro/kernels/dict_match.py::dict_match_pallas``, batched over channels:
sorted candidates ``xs`` (C, n), dictionary rows (C, D, n) in any order and
their extremes ``dmin``/``dmax`` (C, D) give ``ks`` (C, D) float32 and
``mm`` (C, D) bool.  It is the encoder's ``"ops"`` matcher
(``repro_torch.kernels.ops.dict_match``), launched once per block step.

:func:`dict_match_cuda` launches the kernel for CUDA tensors and runs the
plain version, :func:`repro_torch.kernels.ref.dict_match_ref`, for CPU
tensors.  The TPU kernel's ``tile_d`` and tile padding have no counterpart:
the kernel takes any D >= 1.  It sorts each row that is not already sorted
and counts by binary searches (``csrc/ks_count.cuh``, shared with K1);
:func:`plan` gives the launch's shape on a card, asked once per shape.
"""
from __future__ import annotations

import ctypes
import functools
import sys

import numpy as np
import torch

from ..errors import KernelShapeError
from . import _build
from .ref import dict_match_ref

__all__ = ["dict_match_cuda", "launches", "MAX_N", "plan"]

#: Kernel launches since import (or since a caller reset it to 0).
launches = 0

#: The candidate, its sorted copy and a row of each warp, padded to a power
#: of two, and the staged rows must fit in a CTA's shared memory.
MAX_N = 4096


def _kernel():
    """The C entry point, typed once (it is called once per block step)."""
    fn = _build.load("dict_match").dict_match_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _plan(device: torch.device, C: int, D: int, n: int) -> dict:
    fn = _build.load("dict_match").dict_match_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        rc = fn(C, D, n, out)
    if rc != 0:
        raise RuntimeError(f"dict_match plan failed: CUDA error {rc}")
    return {"warps": out[0], "rows_per_warp": out[1],
            "ctas_per_channel": out[2], "ctas": out[2] * C,
            "smem_bytes": out[3], "cta_slots": out[4]}


def plan(C: int, D: int, n: int, device=None) -> dict:
    """The kernel's launch at (C, D, n) on ``device`` (the current card if
    None): warps a CTA, rows a warp, CTAs a channel and in all, shared bytes
    a CTA, and the card's CTA slots at that size (CTAs an SM times SMs).
    Asked of the library once per (device, C, D, n)."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return dict(_plan(torch.device(device), C, D, n))


def _check(xs, rows, dmin, dmax):
    if xs.dim() != 2:
        raise KernelShapeError(
            f"dict_match: xs must be (C, n), got {tuple(xs.shape)}")
    C, n = xs.shape
    D = rows.shape[-2] if rows.dim() == 3 else -1
    want = {"xs": (xs, (C, n)), "rows": (rows, (C, D, n)),
            "dmin": (dmin, (C, D)), "dmax": (dmax, (C, D))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise KernelShapeError(
                f"dict_match: {name} must be {shape} float32, got "
                f"{tuple(t.shape)} {t.dtype}")
        if t.device != xs.device:
            raise KernelShapeError(
                f"dict_match: {name} on {t.device}, xs on {xs.device}")
        if not t.is_contiguous():
            raise KernelShapeError(f"dict_match: {name} is not contiguous")
    if D < 1 or not 1 <= n <= MAX_N or not 1 <= C <= 65535 \
            or C * D * n >= 2 ** 31:
        raise KernelShapeError(
            f"dict_match: shape (C={C}, D={D}, n={n}) outside the kernel's "
            f"range (D >= 1, 1 <= n <= {MAX_N}, 1 <= C <= 65535, "
            f"C*D*n < 2**31)")


def dict_match_cuda(xs, rows, dmin, dmax, rel_tol: float):
    """``(ks (C, D) float32, mm (C, D) bool)`` of float32 candidates
    ``xs`` (C, n), sorted by contract (an unsorted one gives the broadcast
    formula's result), against float32 rows (C, D, n) in any order.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream or raise (:class:`KernelShapeError` for operands the
    kernel does not take, ``RuntimeError`` for a failed launch)."""
    if xs.device.type == "cpu":
        return dict_match_ref(xs, rows, dmin, dmax, rel_tol)
    if xs.device.type != "cuda":
        raise KernelShapeError(f"dict_match: unsupported device {xs.device}")
    _check(xs, rows, dmin, dmax)
    C, D, n = rows.shape
    ks = torch.empty((C, D), dtype=torch.float32, device=xs.device)
    mm = torch.empty((C, D), dtype=torch.bool, device=xs.device)
    p = _plan(xs.device, C, D, n)
    fn = _kernel()
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = fn(xs.data_ptr(), rows.data_ptr(), dmin.data_ptr(),
                dmax.data_ptr(), ks.data_ptr(), mm.data_ptr(), C, D, n,
                p["warps"], p["rows_per_warp"], float(np.float32(rel_tol)),
                float(np.float32(1.0 / n)), stream)
    if rc != 0:
        raise RuntimeError(f"dict_match kernel launch failed: CUDA error {rc}")
    _build.count_launch(sys.modules[__name__])
    return ks, mm
