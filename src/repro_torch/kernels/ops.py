"""Public wrappers around K3 (``dict_match``), with the signatures of the
reference package's ``repro.kernels.ops``.

``dict_match``           -- ``(ks, mm)``; the encoder's ``"ops"`` matcher.
``dict_match_ks``        -- KS distances only (gate discarded).
``dict_match_reference`` -- the plain version with the same signature.

Operands in float16, bfloat16 or float64 are cast to float32 first, as the
TPU kernel casts them.  Unbatched operands (``xs`` (n,), rows (D, n)) and
batched ones (``xs`` (C, n), rows (C, D, n)) are both accepted.
"""
from __future__ import annotations

import torch

from . import dict_match as _k3
from .ref import dict_match_ref

__all__ = ["dict_match", "dict_match_ks", "dict_match_reference"]


def _f32(*ts):
    return [t.to(torch.float32).contiguous() for t in ts]


def dict_match(xs_sorted, dict_blocks, dmin, dmax, rel_tol: float = 0.1):
    """K3 on sorted candidates against rows in any order; returns
    ``(ks, mm)`` of shape (D,) or (C, D)."""
    xs, rows, lo, hi = _f32(xs_sorted, dict_blocks, dmin, dmax)
    if xs.dim() == 1:
        ks, mm = _k3.dict_match_cuda(xs[None], rows[None], lo[None],
                                     hi[None], rel_tol)
        return ks[0], mm[0]
    return _k3.dict_match_cuda(xs, rows, lo, hi, rel_tol)


def dict_match_ks(xs_sorted, dict_sorted, rel_tol: float = 0.5):
    """KS distances from K3 against sorted rows, min/max gate discarded."""
    ks, _ = dict_match(xs_sorted, dict_sorted, dict_sorted[..., 0],
                       dict_sorted[..., -1], rel_tol)
    return ks


def dict_match_reference(xs_sorted, dict_blocks, dmin, dmax,
                         rel_tol: float = 0.1):
    """The plain version with the public signature."""
    return dict_match_ref(*_f32(xs_sorted, dict_blocks, dmin, dmax), rel_tol)
