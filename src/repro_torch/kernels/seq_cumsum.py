"""K2: sequential in-row cumulative sum for the delta-mode decode.

Delta-mode reconstruction (paper Sec. V-B2) rebuilds each block as
``base + cumsum(deltas)``.  The host decoder uses ``np.cumsum``, which
accumulates strictly left to right; a parallel (associative) scan rounds
differently in the last bit.  Byte identity between the host and device
decodes therefore needs a cumsum in the same sequential order: this kernel,
``csrc/seq_cumsum.cu``, which replaces the TPU kernel
``repro/kernels/seq_cumsum.py::seq_cumsum_pallas``.

:func:`seq_cumsum` launches the kernel for a CUDA tensor and runs the plain
version, :func:`seq_cumsum_torch`, for a CPU tensor.  The plain version is
an explicit column loop: ``torch.cumsum`` is not bitwise equal to
``np.cumsum`` in float32.
"""
from __future__ import annotations

import ctypes
import sys

import torch

from ..errors import KernelShapeError
from . import _build

__all__ = ["seq_cumsum", "seq_cumsum_torch", "launches"]

#: Kernel launches since import (or since a caller reset it to 0).
launches = 0

_FNS = {torch.float64: "seq_cumsum_f64", torch.float32: "seq_cumsum_f32",
        torch.float16: "seq_cumsum_f16"}


def seq_cumsum_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version: (R, P) -> row-wise cumsum, one column at a time in the
    tensor's own dtype (bitwise equal to ``np.cumsum(x, axis=1)``)."""
    out = torch.empty_like(x)
    if x.shape[1] == 0:
        return out
    acc = x[:, 0].clone()
    out[:, 0] = acc
    for j in range(1, x.shape[1]):
        acc = acc + x[:, j]
        out[:, j] = acc
    return out


def seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """(R, P) f64/f32/f16 -> row-wise cumsum accumulated left to right.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise (:class:`KernelShapeError` for an operand the kernel does not
    take, ``RuntimeError`` for a failed launch).
    """
    if x.device.type == "cpu":
        return seq_cumsum_torch(x)
    if x.device.type != "cuda":
        raise KernelShapeError(f"seq_cumsum: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype not in _FNS:
        raise KernelShapeError(
            f"seq_cumsum takes a 2-D f64/f32/f16 tensor, got "
            f"{tuple(x.shape)} {x.dtype}")
    x = x.contiguous()
    R, P = x.shape
    if R >= 2 ** 31 or P >= 2 ** 31:
        raise KernelShapeError(f"seq_cumsum: shape {tuple(x.shape)} too large")
    out = torch.empty_like(x)
    if R == 0 or P == 0:
        return out
    fn = getattr(_build.load("seq_cumsum"), _FNS[x.dtype])
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), R, P, stream)
    if rc != 0:
        raise RuntimeError(f"seq_cumsum kernel launch failed: CUDA error {rc}")
    _build.count_launch(sys.modules[__name__])
    return out
