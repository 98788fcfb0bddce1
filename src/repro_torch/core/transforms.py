"""Residual and delta transforms for non-stationary data (paper Sec. IV-A).

Each block keeps its first sample as the *base value*; the LEM processing
runs on the B-1 transformed values (residual: ``x - x_0``, delta: the first
difference).  Bounded ranges (e.g. phase angles in [0, 360)) wrap the
transformed values into ``[-(rmax-rmin)/2, +(rmax-rmin)/2)`` and the
reconstructed values into ``[rmin, rmax)``.

The host codec transforms with the numpy twins; the device decode wraps
with :func:`wrap_range`, which is bitwise equal to :func:`np_wrap_range`
(``torch.remainder`` and ``np.mod`` share the fmod-then-fix-sign rule; the
only difference, the sign of an exact-zero remainder, is erased by the
``+ rmin`` that follows for every ``rmin`` other than ``-0.0``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["np_wrap_centered", "np_wrap_range", "wrap_centered",
           "wrap_range", "residual_forward", "residual_inverse",
           "delta_forward", "delta_inverse"]


def np_wrap_centered(v, rmin, rmax):
    """Wrap transformed values into [-(rmax-rmin)/2, +(rmax-rmin)/2)."""
    w = rmax - rmin
    return np.mod(v + 0.5 * w, w) - 0.5 * w


def np_wrap_range(v, rmin, rmax):
    """Wrap reconstructed values into [rmin, rmax)."""
    w = rmax - rmin
    return np.mod(v - rmin, w) + rmin


def wrap_range(v: torch.Tensor, rmin: float, rmax: float) -> torch.Tensor:
    """Tensor twin of :func:`np_wrap_range` (same dtype in, same out)."""
    return torch.remainder(v - rmin, rmax - rmin) + rmin


def wrap_centered(v: torch.Tensor, rmin: float, rmax: float) -> torch.Tensor:
    """Tensor twin of :func:`np_wrap_centered`."""
    w = rmax - rmin
    return torch.remainder(v + 0.5 * w, w) - 0.5 * w


def residual_forward(blocks, value_range: Optional[Tuple[float, float]] = None):
    """blocks (..., B) -> (bases (...,), residuals (..., B-1))."""
    blocks = torch.as_tensor(blocks)
    base = blocks[..., 0]
    res = blocks[..., 1:] - base[..., None]
    if value_range is not None:
        res = wrap_centered(res, *value_range)
    return base, res


def residual_inverse(base, res,
                     value_range: Optional[Tuple[float, float]] = None):
    """(bases (...,), residuals (..., B-1)) -> blocks (..., B)."""
    base = torch.as_tensor(base)[..., None]
    vals = torch.cat([base, base + torch.as_tensor(res)], dim=-1)
    if value_range is not None:
        vals = wrap_range(vals, *value_range)
    return vals


def delta_forward(blocks, value_range: Optional[Tuple[float, float]] = None):
    """blocks (..., B) -> (bases (...,), deltas (..., B-1))."""
    blocks = torch.as_tensor(blocks)
    base = blocks[..., 0]
    d = blocks[..., 1:] - blocks[..., :-1]
    if value_range is not None:
        d = wrap_centered(d, *value_range)
    return base, d


def delta_inverse(base, deltas,
                  value_range: Optional[Tuple[float, float]] = None):
    """(bases (...,), deltas (..., B-1)) -> blocks (..., B) via a cumsum
    (``torch.cumsum``, the reference's ``jnp.cumsum``; the codec's decode
    takes K2 instead)."""
    base = torch.as_tensor(base)[..., None]
    vals = torch.cat([base, base + torch.cumsum(torch.as_tensor(deltas),
                                                dim=-1)], dim=-1)
    if value_range is not None:
        vals = wrap_range(vals, *value_range)
    return vals
