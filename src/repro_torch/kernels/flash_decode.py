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
version, :func:`flash_decode_torch`, for CPU tensors.  For meta tensors (a
dry run's trace) it launches nothing and returns an empty output; for
``DTensor`` operands it runs on the local shards (:func:`_on_shards`).  On
the card and on meta it reports its reckoned cost (:func:`cost`) to the
active cost counters (``launch.hlo_cost``), so a traced step and a real
one count the same FLOPs and bytes.  The TPU kernel's
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

__all__ = ["flash_decode", "flash_decode_torch", "cost", "launches",
           "NEG_INF"]

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


def cost(q, k_cache, v_cache, valid):
    """K4's reckoned (FLOPs, bytes): the FLOPs of its plain version's two
    einsums, 4*B*H*C*hd; the bytes of the K/V cache in its own dtype, q,
    valid and the float32 output, each read or written once."""
    B, H, hd = q.shape
    C = k_cache.shape[1]
    flops = 4 * B * H * C * hd
    nbytes = sum(t.numel() * t.element_size()
                 for t in (q, k_cache, v_cache, valid)) + B * H * hd * 4
    return flops, nbytes


def _on_shards(q, k_cache, v_cache, valid):
    """K4 on the local shards of ``DTensor`` operands.  The cache decides
    the layout: its batch dim's mesh axes shard q's and valid's batch, its
    kv-head dim's shard q's heads (each shard's query heads then read its
    own kv heads), every other mesh axis replicates; an operand in another
    layout is redistributed (a counted collective).  A cache sharded along
    its sequence takes ``models.attention``'s distributed softmax
    instead."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = k_cache.device_mesh
    kp = tuple(k_cache.placements)
    if any(p.is_shard(1) for p in kp):
        raise KernelShapeError(
            "flash_decode: a cache sharded along its sequence has no local "
            "K4 call (models.attention merges the shards' softmaxes)")
    qp = tuple(Shard(0) if p.is_shard(0) else Shard(1) if p.is_shard(2)
               else Replicate() for p in kp)
    vp = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in kp)

    def placed(t, placements):
        if not isinstance(t, DTensor):  # a plain tensor is replicated
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        if tuple(t.placements) != placements:
            t = t.redistribute(mesh, placements)
        return t.to_local()

    out = flash_decode(placed(q, qp), k_cache.to_local(),
                       placed(v_cache, kp), placed(valid, vp))
    return DTensor.from_local(out, mesh, qp, run_check=False,
                              shape=q.shape, stride=q.stride())


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


def _check(q, k_cache, v_cache, valid, pointers: bool = True):
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
        if pointers and (not t.is_contiguous() or t.data_ptr() % 16):
            raise KernelShapeError(
                f"flash_decode: {name} is not contiguous or not 16-byte "
                f"aligned (the kernel copies rows in 16-byte pieces)")
    if pointers and q.data_ptr() % 16:
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
    kernel does not take, ``RuntimeError`` for a failed launch).  Meta
    tensors launch nothing: an empty output, the cost reported to the
    active counters.  ``DTensor`` operands run on their local shards."""
    if hasattr(k_cache, "placements"):  # a DTensor
        return _on_shards(q, k_cache, v_cache, valid)
    if q.device.type == "cpu":
        return flash_decode_torch(q, k_cache, v_cache, valid)
    if q.device.type == "meta":
        _check(q, k_cache, v_cache, valid, pointers=False)
        _build.report_cost(*cost(q, k_cache, v_cache, valid))
        return torch.empty(q.shape, dtype=torch.float32, device="meta")
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
    if _build.cost_counters:
        _build.report_cost(*cost(q, k_cache, v_cache, valid))
    return out
