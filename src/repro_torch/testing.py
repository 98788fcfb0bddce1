"""Operands at the edges of the kernels' range, made from a seed with numpy.

``chip_smoke.py`` and the tests hold the kernels to their plain versions on
them.
"""
from __future__ import annotations

import numpy as np

__all__ = ["k3_special"]

#: A NaN with its sign bit set.
NEG_NAN = np.array([0xFFC00000], dtype=np.uint32).view(np.float32)[0]


def k3_special(C: int, D: int, n: int, seed: int, cand_sorted: bool = True,
               rows_sorted: bool = False):
    """K3 operands: float32 candidates (C, n) and rows (C, D, n) with ties,
    -0.0 beside +0.0, +-inf and NaNs of both signs, row 0 a permutation of
    the candidate; the candidates sorted (NaNs last) unless ``cand_sorted``
    is false, the rows sorted if ``rows_sorted``; and the rows' non-NaN
    extremes ``dmin``/``dmax`` (C, D)."""
    rng = np.random.default_rng(seed)
    a = np.round(rng.normal(size=(C, D + 1, n)), 1).astype(np.float32)
    for val, p in ((0.0, 0.1), (-0.0, 0.1), (np.inf, 0.03), (-np.inf, 0.03),
                   (np.nan, 0.03), (NEG_NAN, 0.03)):
        a[rng.random(a.shape) < p] = val
    xs = np.sort(a[:, 0], axis=-1) if cand_sorted else a[:, 0].copy()
    rows = a[:, 1:].copy()
    rows[:, 0] = a[:, 0, rng.permutation(n)]
    if rows_sorted:
        rows = np.sort(rows, axis=-1)
    dmin = np.where(np.isnan(rows), np.inf, rows).min(-1)
    dmax = np.where(np.isnan(rows), -np.inf, rows).max(-1)
    return xs, rows, dmin.astype(np.float32), dmax.astype(np.float32)
