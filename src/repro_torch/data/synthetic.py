"""Synthetic uPMU telemetry mimicking the paper's evaluation data
(Sec. VII): magnitude channels (locally stationary noise around a level,
with occasional level shifts and brief tap-change steps) and phase-angle
channels (a constantly increasing ramp wrapping in [0, 360)).  Same
generators, same numpy streams, as the reference package's."""
from __future__ import annotations

import numpy as np

__all__ = ["pmu_magnitude", "pmu_angle"]


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
