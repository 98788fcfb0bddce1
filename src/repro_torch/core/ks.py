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

__all__ = ["kolmogorov_sf", "ks_pvalue", "ks_statistic_many",
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


def ks_statistic_many(xs_sorted: torch.Tensor,
                      dict_sorted: torch.Tensor) -> torch.Tensor:
    """KS statistic of sorted candidates against stacks of sorted blocks.

    ``xs_sorted`` (..., n) and ``dict_sorted`` (..., D, n) -> (..., D) in
    float32: the maximum ECDF gap evaluated at every sample point of both
    samples (``searchsorted(side="right")`` counts divided by n), the same
    arithmetic as the reference package's ``ks_statistic_many``.
    """
    n1 = xs_sorted.shape[-1]
    n2 = dict_sorted.shape[-1]
    xs = xs_sorted.unsqueeze(-2).expand(
        *dict_sorted.shape[:-1], n1).contiguous()
    ys = dict_sorted.contiguous()
    f32 = torch.float32
    dev = xs.device
    fx_at_x = torch.arange(1, n1 + 1, dtype=f32, device=dev) / n1
    fy_at_x = torch.searchsorted(ys, xs, right=True).to(f32) / n2
    d1 = torch.amax(torch.abs(fx_at_x - fy_at_x), dim=-1)
    fy_at_y = torch.arange(1, n2 + 1, dtype=f32, device=dev) / n2
    fx_at_y = torch.searchsorted(xs, ys, right=True).to(f32) / n1
    d2 = torch.amax(torch.abs(fx_at_y - fy_at_y), dim=-1)
    return torch.maximum(d1, d2)


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
