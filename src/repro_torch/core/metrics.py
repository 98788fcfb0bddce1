"""Time-series quality measures (paper Table II) and spectral analysis helpers.

Measures:
  #1 number of local maxima (peaks)
  #2 mean distance (in samples) between consecutive peaks
  #3 mean absolute difference between consecutive peak values
  #4 mean absolute jump size |x[i+1]-x[i]|
  #5 number of jumps larger than 10% of (max-min) of the series
  #6 percentage of points outside the Tukey box-plot whiskers (1.5 IQR)
"""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["peaks", "quality_measures", "amplitude_spectrum", "spectral_band_error"]


def peaks(x: np.ndarray) -> np.ndarray:
    """Indices of strict local maxima."""
    x = np.asarray(x)
    if len(x) < 3:
        return np.zeros((0,), dtype=np.int64)
    mid = x[1:-1]
    mask = (mid > x[:-2]) & (mid > x[2:])
    return np.nonzero(mask)[0] + 1


def quality_measures(x: np.ndarray) -> Dict[str, float]:
    x = np.asarray(x, dtype=np.float64)
    p = peaks(x)
    jumps = np.abs(np.diff(x))
    rng = float(np.max(x) - np.min(x)) if len(x) else 0.0
    q1, q3 = np.percentile(x, [25, 75]) if len(x) else (0.0, 0.0)
    iqr = q3 - q1
    lo, hi = q1 - 1.5 * iqr, q3 + 1.5 * iqr
    return {
        "m1_num_peaks": float(len(p)),
        "m2_mean_peak_dist": float(np.mean(np.diff(p))) if len(p) > 1 else 0.0,
        "m3_mean_peak_value_dist": float(np.mean(np.abs(np.diff(x[p])))) if len(p) > 1 else 0.0,
        "m4_mean_jump": float(np.mean(jumps)) if len(jumps) else 0.0,
        "m5_num_big_jumps": float(np.sum(jumps > 0.1 * rng)) if rng > 0 else 0.0,
        "m6_pct_outliers": float(100.0 * np.mean((x < lo) | (x > hi))) if len(x) else 0.0,
    }


def amplitude_spectrum(x: np.ndarray) -> np.ndarray:
    """Single-sided DFT amplitude spectrum, DC excluded (paper Sec. VII-C)."""
    f = np.abs(np.fft.rfft(np.asarray(x, dtype=np.float64)))
    return f[1:]


def spectral_band_error(orig: np.ndarray, recon: np.ndarray, low_frac: float = 0.05):
    """Relative log-amplitude error in the low band vs the full band.

    The paper's claim: low-frequency components (the ones that matter for the
    application domain) are well preserved; high-frequency amplitudes may be
    boosted by the random permutation (std mode).
    """
    a, b = amplitude_spectrum(orig), amplitude_spectrum(recon)
    n = min(len(a), len(b))
    a, b = a[:n] + 1e-12, b[:n] + 1e-12
    k = max(int(low_frac * n), 1)
    err = np.abs(np.log10(b) - np.log10(a))
    return {
        "low_band_logerr": float(np.mean(err[:k])),
        "full_band_logerr": float(np.mean(err)),
        "high_band_logerr": float(np.mean(err[n // 2:])),
    }
