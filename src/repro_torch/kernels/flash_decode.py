"""K4: single-token grouped-query attention against a KV cache.

``csrc/flash_decode.cu`` replaces the TPU kernel
``repro/kernels/flash_decode.py::flash_decode_pallas``.  It is the core of
the serve path's :func:`repro_torch.models.attention.decode_attention`, one
launch per attention layer and decode step: a pre-scaled float32 query
``q`` (B, H, hd) against the ring cache ``k_cache``/``v_cache``
(B, C, Hkv, hd) (float32, float16 or bfloat16), masked by ``valid`` (B, C)
to -1e30, softmax, then the weighted sum of V -> (B, H, hd) float32.  Query
head ``h`` reads kv head ``h // (H // Hkv)``.

:func:`flash_decode` launches the kernel for CUDA tensors and runs the plain
version, :func:`flash_decode_torch`, for CPU tensors.  The TPU kernel's
``CHUNK_C`` and its ``C % chunk == 0`` assertion have no counterpart: the
kernel takes any C >= 1.  It splits the cache axis across CTAs; the split
count comes from the library's ``*_plan`` entry (B, Hkv, C and the card's
SM count and occupancy), cached per shape, and with more than one split
the wrapper allocates the float32 workspace of the splits' partial
results, which a second kernel of the same launch merges.
"""
from __future__ import annotations

import ctypes
import functools
import sys

import torch

from ..errors import KernelShapeError
from . import _build

__all__ = ["flash_decode", "flash_decode_torch", "launches", "NEG_INF"]

#: Kernel launches since import (or since a caller reset it to 0).
launches = 0

#: The score of a masked position (``attention.py``'s ``_NEG_INF``): a row
#: whose every position is masked averages V instead of giving NaN.
NEG_INF = -1e30

_FNS = {torch.float32: "flash_decode_f32", torch.float16: "flash_decode_f16",
        torch.bfloat16: "flash_decode_bf16"}
# The C entry points return this when the two-stage ring of K and V tiles
# does not fit in a CTA's shared memory, or hd > 256; the plan entry
# returns -(_ERR_CUDA + e) for a CUDA error e.
_ERR_SMEM = -1
_ERR_CUDA = 1000


def flash_decode_torch(q, k_cache, v_cache, valid):
    """Plain version (``repro/kernels/ref.py::flash_decode_ref``): the grouped
    einsum in float32, masked positions at -1e30, softmax, weighted V."""
    B, H, hd = q.shape
    Hkv = k_cache.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, hd).float()
    s = torch.einsum("bkgd,bckd->bkgc", qg, k_cache.float())
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgc,bckd->bkgd", p, v_cache.float())
    return o.reshape(B, H, hd)


def _kernel(dtype):
    """The C entry point for a cache dtype, typed once (it is called once
    per attention layer and decode step)."""
    fn = getattr(_build.load("flash_decode"), _FNS[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] \
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _splits(device, dtype, B, C, Hkv, G, hd):
    """The kernel's split count of the cache axis for this shape on this
    card (the C entry's plan, asked once per shape)."""
    fn = getattr(_build.load("flash_decode"), _FNS[dtype] + "_plan")
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        splits = fn(B, C, Hkv, G, hd)
    if splits == _ERR_SMEM:
        raise KernelShapeError(
            f"flash_decode: a two-stage ring of {dtype} K and V tiles of "
            f"hd={hd} does not fit in a CTA's shared memory, or hd > 256 "
            f"(one 8-element piece of a row a lane)")
    if splits < 1:
        raise RuntimeError(f"flash_decode plan failed: CUDA error "
                           f"{-splits - _ERR_CUDA}")
    return splits


def _check(q, k_cache, v_cache, valid):
    if q.dim() != 3 or q.dtype != torch.float32 or not q.is_contiguous():
        raise KernelShapeError(
            f"flash_decode: q must be a contiguous (B, H, hd) float32 tensor, "
            f"got {tuple(q.shape)} {q.dtype}")
    B, H, hd = q.shape
    if k_cache.dim() != 4:
        raise KernelShapeError(
            f"flash_decode: k_cache must be (B, C, Hkv, hd), got "
            f"{tuple(k_cache.shape)}")
    C, Hkv = k_cache.shape[1], k_cache.shape[2]
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if tuple(t.shape) != (B, C, Hkv, hd) or t.dtype not in _FNS \
                or t.dtype != k_cache.dtype:
            raise KernelShapeError(
                f"flash_decode: {name} must be {(B, C, Hkv, hd)} float32, "
                f"float16 or bfloat16 (one dtype for both caches), got "
                f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise KernelShapeError(
                f"flash_decode: {name} is not contiguous or not 16-byte "
                f"aligned (the kernel copies rows in 16-byte pieces)")
    if q.data_ptr() % 16:
        raise KernelShapeError(
            "flash_decode: q is not 16-byte aligned (the kernel reads it "
            "with 16-byte loads)")
    if tuple(valid.shape) != (B, C) or valid.dtype != torch.bool \
            or (C > 1 and valid.stride(1) != 1):
        raise KernelShapeError(
            f"flash_decode: valid must be ({B}, {C}) bool with unit stride "
            f"along C, got {tuple(valid.shape)} {valid.dtype} "
            f"stride {valid.stride()}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("valid", valid)):
        if t.device != q.device:
            raise KernelShapeError(
                f"flash_decode: {name} on {t.device}, q on {q.device}")
    if Hkv < 1 or H % Hkv or not 1 <= C < 2 ** 31 or hd < 8 or hd % 8 \
            or B > 65535 or Hkv > 65535:
        raise KernelShapeError(
            f"flash_decode: shape (B={B}, H={H}, Hkv={Hkv}, C={C}, hd={hd}) "
            f"outside the kernel's range (H a multiple of Hkv, 1 <= C < "
            f"2**31, hd a multiple of 8, B and Hkv <= 65535)")


def flash_decode(q, k_cache, v_cache, valid):
    """``(B, H, hd)`` float32 attention of the pre-scaled float32 query
    ``q`` (B, H, hd) over ``k_cache``/``v_cache`` (B, C, Hkv, hd), masked
    by ``valid`` (B, C) bool (a view broadcast over B is taken as is).

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream or raise (:class:`KernelShapeError` for operands the
    kernel does not take, ``RuntimeError`` for a failed launch)."""
    if q.device.type == "cpu":
        return flash_decode_torch(q, k_cache, v_cache, valid)
    if q.device.type != "cuda":
        raise KernelShapeError(f"flash_decode: unsupported device {q.device}")
    _check(q, k_cache, v_cache, valid)
    B, H, hd = q.shape
    C, Hkv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    fn = _kernel(k_cache.dtype)
    splits = _splits(q.device, k_cache.dtype, B, C, Hkv, H // Hkv, hd)
    ws_acc = ws_ml = 0
    if splits > 1:  # the splits' (acc, (m, l)) for the combine kernel
        ws = torch.empty(splits * B * H * (hd + 2), dtype=torch.float32,
                         device=q.device)
        ws_acc = ws.data_ptr()
        ws_ml = ws_acc + 4 * splits * B * H * hd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                valid.data_ptr(), valid.stride(0), out.data_ptr(), ws_acc,
                ws_ml, B, C, Hkv, H // Hkv, hd, splits, stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_decode kernel launch failed: CUDA error {rc}")
    _build.count_launch(sys.modules[__name__])
    return out
