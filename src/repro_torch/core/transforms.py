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

import numpy as np
import torch

__all__ = ["np_wrap_centered", "np_wrap_range", "wrap_range"]


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
