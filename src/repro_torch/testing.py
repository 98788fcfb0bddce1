"""Operands at the edges of the kernels' range, made from a seed with numpy.

``chip_smoke.py`` and the tests hold the kernels to their plain versions on
them.
"""
from __future__ import annotations

import numpy as np

__all__ = ["k3_special", "mixed_cohort"]

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


def mixed_cohort(C: int, nb: int, n: int, seed: int, widths=None,
                 nonfinite: bool = False):
    """A padded mixed-mode cohort as adaptive sessions stage it, for K1's
    ``chan`` operand and the mixed scans: float32 blocks (C, nb, n) near one
    of 8 templates (half the blocks with noise 0.05, half 0.6, so there are
    hits, misses and error-bound demotions), each lane's columns past its
    width ``nf`` (C,) (``widths``, else drawn from [n - 3, n] with lane 0
    at n) set to +inf; a block mask (C, nb) with lane 1 masked every 5th
    block; per-lane ``d_crit`` (C,) float32 (the 0.4 quantile threshold,
    scaled by 0.75 or 1), ``err_cum`` and ``eb_on`` (C,) bools.
    ``nonfinite`` rounds to one decimal (ties) and sprinkles -0.0, and puts
    a NaN, +inf or -inf into a quarter of the blocks each, inside the
    lane's width.  Returns ``(blocks, valid, nf, d_crit, err_cum, eb_on)``.
    """
    rng = np.random.default_rng(seed)
    if widths is None:
        nf = rng.integers(max(1, n - 3), n + 1, C)
        nf[0] = n
    else:
        nf = np.asarray(widths, np.int64)
    tmpl = rng.normal(0, 1, (8, n))
    noise = np.where(rng.random((C, nb, 1)) < 0.5, 0.05, 0.6)
    x = tmpl[rng.integers(0, 8, (C, nb))] + noise * rng.normal(
        0, 1, (C, nb, n))
    if nonfinite:
        x = np.round(x, 1)
        x[rng.random(x.shape) < 0.05] = -0.0
        kind = rng.integers(0, 4, (C, nb))
        col = rng.integers(0, n, (C, nb)) % nf[:, None]
        for k, val in ((1, np.nan), (2, np.inf), (3, -np.inf)):
            ci, bi = np.nonzero(kind == k)
            x[ci, bi, col[ci, bi]] = val
    x[np.broadcast_to(np.arange(n) >= nf[:, None, None], x.shape)] = np.inf
    valid = np.ones((C, nb), dtype=bool)
    if C > 1:
        valid[1, ::5] = False
    d_crit = ((np.floor(0.4 * nf) + 0.5) / nf
              * np.where(rng.random(C) < 0.5, 0.75, 1.0))
    return (x.astype(np.float32), valid, nf, d_crit.astype(np.float32),
            rng.random(C) < 0.5, rng.random(C) < 0.7)
