"""Two-sample Kolmogorov-Smirnov machinery for the LEM similarity measure.

The paper (Sec. III-A) uses the two-sample KS test as the exchangeability
measure: statistic D = sup_x |F1(x) - F2(x)| (eq. 1), standardized by
sqrt(n1*n2/(n1+n2)) (eq. 2), mapped to a p-value with the asymptotic
Kolmogorov distribution.  A block is exchangeable with a stored source
distribution when p >= alpha.

The p-value is monotone in the statistic, so the alpha threshold is
converted once on the host into a critical distance
(:func:`critical_distance`) and the encoder compares plain distances.
``critical_distance`` is plain numpy and returns the same Python float as
the reference package's, because that threshold feeds every decision.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["kolmogorov_sf", "ks_pvalue", "ks_statistic",
           "ks_statistic_sorted", "ks_statistic_many",
           "ks_statistic_many_masked", "searchsorted_right",
           "critical_distance"]

_SERIES_TERMS = 40

# Below this the alternating series needs more terms than we carry: the
# partial sums of the even-truncated series cancel as lam -> 0.  The true
# survival function satisfies 1 - Q(0.1) ~ 4e-53, far below f64 resolution,
# so returning exactly 1.0 under the cutoff agrees with
# scipy.special.kolmogorov to machine precision.
_SMALL_LAM = 0.1


def kolmogorov_sf(lam) -> torch.Tensor:
    """Survival function of the Kolmogorov distribution.

    Q_KS(lam) = 2 * sum_{j>=1} (-1)^{j-1} exp(-2 j^2 lam^2), clipped to
    [0, 1]; exactly 1.0 below ``_SMALL_LAM``.  Floating inputs keep their
    dtype; anything else is evaluated in float32.
    """
    lam = torch.as_tensor(lam)
    if not lam.is_floating_point():
        lam = lam.to(torch.float32)
    j = torch.arange(1, _SERIES_TERMS + 1, dtype=lam.dtype, device=lam.device)
    lam_ = torch.clamp(lam, min=1e-12)
    sign = torch.where(j % 2 == 1, 1.0, -1.0).to(lam.dtype)
    terms = sign * torch.exp(-2.0 * (j ** 2) * (lam_[..., None] ** 2))
    q = 2.0 * torch.sum(terms, dim=-1)
    return torch.where(lam_ < _SMALL_LAM, torch.ones_like(q),
                       torch.clamp(q, 0.0, 1.0))


def ks_pvalue(d, n1: int, n2: int) -> torch.Tensor:
    """Asymptotic two-sided two-sample KS p-value (scipy ``mode='asymp'``);
    exactly 1.0 for identical samples (``d == 0``)."""
    d = torch.as_tensor(d)
    en = (n1 * n2) / (n1 + n2)
    return kolmogorov_sf(np.sqrt(en) * d)


def _sort_key(x: torch.Tensor) -> torch.Tensor:
    """Integer keys ordered as the reference's sort comparator orders
    floats: -0.0 equals +0.0, every NaN is one value above +inf."""
    itype = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
    x = torch.where(x == 0, torch.zeros_like(x), x)
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    b = x.view(itype)
    return b ^ ((b >> (8 * x.element_size() - 1))
                & torch.iinfo(itype).max)


def searchsorted_right(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``jnp.searchsorted(a, v, side="right")`` along the last axis of
    ``a`` (..., m) for queries ``v`` (..., k) with the same leading axes:
    the reference's binary search (``method="scan"``) probe for probe, in
    its sort order (NaN above +inf, -0.0 == +0.0).  On sorted rows that is
    the count of points ``<=`` each query; on a row that is not sorted in
    that order (a NaN before a grown ``+inf`` pad) it is whatever the
    reference's probes give, which ``torch.searchsorted`` would not."""
    m = a.shape[-1]
    dt = torch.promote_types(a.dtype, v.dtype)
    ka, kv = _sort_key(a.to(dt)), _sort_key(v.to(dt))
    low = torch.zeros(kv.shape, dtype=torch.int64, device=v.device)
    high = torch.full(kv.shape, m, dtype=torch.int64, device=v.device)
    for _ in range(int(np.ceil(np.log2(m + 1)))):
        mid = (low + high) // 2
        left = kv < torch.gather(ka, -1, mid.clamp(max=m - 1))
        low = torch.where(left, low, mid)
        high = torch.where(left, mid, high)
    return high


def _ecdf_gaps(xs, ys, div):
    """The two ECDF gap tables of sorted candidates ``xs`` (..., D, m)
    against rows ``ys`` (..., D, m) with divisor ``div``: at the
    candidate's points and at the rows' points."""
    m = xs.shape[-1]
    f32 = torch.float32
    pos = torch.arange(1, m + 1, dtype=f32, device=xs.device)
    d1 = torch.abs(pos / div - searchsorted_right(ys, xs).to(f32) / div)
    d2 = torch.abs(searchsorted_right(xs, ys).to(f32) / div - pos / div)
    return d1, d2


def _ecdf_distance_sorted(xs, ys):
    """sup_x |F_x - F_y| of sorted 1-D samples ``xs`` (n1,) and ``ys``
    (n2,), evaluated at every point of both (the ECDFs are right-continuous
    step functions, so the sup sits at a jump), in float32 as the
    reference's ``_ecdf_distance_sorted``."""
    n1, n2 = xs.shape[0], ys.shape[0]
    f32 = torch.float32
    fx_at_x = torch.arange(1, n1 + 1, dtype=f32, device=xs.device) / n1
    fy_at_x = searchsorted_right(ys, xs).to(f32) / n2
    d1 = torch.max(torch.abs(fx_at_x - fy_at_x))
    fy_at_y = torch.arange(1, n2 + 1, dtype=f32, device=ys.device) / n2
    fx_at_y = searchsorted_right(xs, ys).to(f32) / n1
    d2 = torch.max(torch.abs(fx_at_y - fy_at_y))
    return torch.maximum(d1, d2)


def ks_statistic_sorted(xs, ys) -> torch.Tensor:
    """KS statistic between two already-sorted samples."""
    return _ecdf_distance_sorted(torch.as_tensor(xs), torch.as_tensor(ys))


def ks_statistic(x, y) -> torch.Tensor:
    """KS statistic between two unsorted samples (sorted NaN last, as
    ``jnp.sort`` sorts)."""
    return _ecdf_distance_sorted(torch.sort(torch.as_tensor(x)).values,
                                 torch.sort(torch.as_tensor(y)).values)


def ks_statistic_many(xs_sorted: torch.Tensor,
                      dict_sorted: torch.Tensor) -> torch.Tensor:
    """KS statistic of sorted candidates against stacks of sorted blocks.

    ``xs_sorted`` (..., n) and ``dict_sorted`` (..., D, n) -> (..., D) in
    float32: the maximum ECDF gap evaluated at every sample point of both
    samples (``searchsorted(side="right")`` counts divided by n), the same
    arithmetic as the reference package's ``ks_statistic_many``; NaNs
    count in the reference's sort order (:func:`searchsorted_right`).
    """
    xs = xs_sorted.unsqueeze(-2).expand(dict_sorted.shape).contiguous()
    d1, d2 = _ecdf_gaps(xs, dict_sorted.contiguous(), xs.shape[-1])
    return torch.maximum(d1.amax(-1), d2.amax(-1))


def ks_statistic_many_masked(xs_sorted: torch.Tensor,
                             dict_sorted: torch.Tensor, nf: torch.Tensor,
                             col_ok: torch.Tensor) -> torch.Tensor:
    """:func:`ks_statistic_many` for the mixed-mode (adaptive) scan:
    candidates (C, m) and rows (C, D, m) padded to a common width with
    ``+inf``; ``nf`` (C,) float32 is each channel's logical width and
    ``col_ok`` (C, m) its real columns.  The counts run over all m columns,
    are divided by ``nf`` and the gaps of the pad columns are zero-filled
    before the max, as in the reference's ``ks_statistic_many_masked``."""
    xs = xs_sorted.unsqueeze(-2).expand(dict_sorted.shape).contiguous()
    d1, d2 = _ecdf_gaps(xs, dict_sorted.contiguous(), nf[:, None, None])
    ok = col_ok[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=xs.device)
    return torch.maximum(torch.where(ok, d1, zero).amax(-1),
                         torch.where(ok, d2, zero).amax(-1))


def critical_distance(alpha: float, n1: int, n2: int) -> float:
    """Invert the asymptotic p-value: largest D with p(D) >= alpha.

    Host-side scalar (numpy bisection); decision ``p >= alpha`` is exactly
    ``D <= critical_distance(alpha, n1, n2)`` up to float tolerance since
    the same series is used in both directions.
    """
    if not (0.0 < alpha < 1.0):
        raise ValueError(f"alpha must be in (0,1), got {alpha}")
    en = (n1 * n2) / (n1 + n2)

    def q(lam: float) -> float:
        if lam < _SMALL_LAM:
            return 1.0
        j = np.arange(1, _SERIES_TERMS + 1)
        val = 2.0 * np.sum((-1.0) ** (j - 1) * np.exp(-2.0 * j * j * lam * lam))
        return float(np.clip(val, 0.0, 1.0))

    lo, hi = 1e-9, 10.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if q(mid) >= alpha:
            lo = mid
        else:
            hi = mid
    return lo / np.sqrt(en)
