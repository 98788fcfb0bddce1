"""Synthetic data: uPMU telemetry mimicking the paper's evaluation data
(Sec. VII): magnitude channels (locally stationary noise around a level,
with occasional level shifts and brief tap-change steps) and phase-angle
channels (a constantly increasing ramp wrapping in [0, 360)); EEG-like
1/f noise (the spectral-analysis data set, Fig. 13); token streams for
the LM trainer.  Same generators, same numpy streams, as the reference
package's."""
from __future__ import annotations

import numpy as np

__all__ = ["pmu_magnitude", "pmu_angle", "eeg_like", "token_stream"]


def pmu_magnitude(n: int, *, level: float = 7200.0, noise: float = 1.5,
                  n_shifts: int = 4, n_taps: int = 6, tap_step: float = 45.0,
                  tap_len: int = 20, seed: int = 0) -> np.ndarray:
    """Voltage/current magnitude: noise + level shifts + brief tap changes."""
    rng = np.random.default_rng(seed)
    x = level + rng.normal(0, noise, n)
    for s in rng.integers(0, max(n - 1, 1), n_shifts):
        x[s:] += rng.normal(0, 4 * noise)
    for s in rng.integers(0, max(n - tap_len - 1, 1), n_taps):
        x[s:s + tap_len] += tap_step * rng.choice([-1.0, 1.0])
    return x


def pmu_angle(n: int, *, slope: float = 0.72, noise: float = 0.05,
              seed: int = 0) -> np.ndarray:
    """Phase angle: wrapping ramp in [0, 360) (paper Fig. 6)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    return np.mod(t * slope + rng.normal(0, noise, n), 360.0)


def eeg_like(n: int, *, alpha: float = 1.0, seed: int = 0) -> np.ndarray:
    """1/f^alpha pink-ish noise via spectral shaping (Fig. 13 data set)."""
    rng = np.random.default_rng(seed)
    f = np.fft.rfftfreq(n)
    f[0] = f[1] if n > 1 else 1.0
    spec = (rng.normal(size=len(f)) + 1j * rng.normal(size=len(f)))
    spec /= f ** (alpha / 2.0)
    x = np.fft.irfft(spec, n)
    return (x / np.std(x)).astype(np.float64)


def token_stream(n_batches: int, batch: int, seq: int, vocab: int,
                 seed: int = 0):
    """Zipf-distributed token batches with next-token labels."""
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        toks = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64)
        toks = np.clip(toks, 0, vocab - 1).astype(np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
