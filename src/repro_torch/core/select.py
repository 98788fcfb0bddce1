"""Adaptive per-channel mode selection.

A copy of the reference package's ``core/select.py`` (numpy only): the
port imports nothing of that package.

IDEALEM's three payload transforms trade off differently with the signal
shape: ``std`` wants locally exchangeable samples, ``residual``/``delta``
want smooth autocorrelated ones (the paper fixes the choice per run).  For
long mixed streams the right transform changes over time, so a session can
instead carry one ``ChannelSelector`` per channel: cheap streaming
statistics over a rolling warmup-sized window drive an online mode choice
plus a quantized KS-threshold adjustment.

Predictors (the arXiv:2111.13789 family):

  * ``rho1``        lag-1 autocorrelation of the window -- high values mean
                    the diff/residual payloads are small and stable, so
                    ``delta``/``residual`` beat ``std``;
  * ``var_ratio``   window variance over the reference (first-window)
                    variance -- a non-stationarity signal;
  * ``range_drift`` fraction of the reference range by which the window's
                    extremes escape it -- the min/max gate's failure mode.

Decisions are deliberately sticky so channels do not flap: a mode/scale
change must clear the threshold by a ``hysteresis`` margin, repeat for
``patience`` consecutive evaluations, and respect a ``min_dwell_blocks``
spacing from the previous switch.  The session applies accepted switches
only at feed boundaries (segment restarts), never mid-segment.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["SelectorConfig", "SelectionEvent", "ChannelSelector"]

_MODE_ORDER = ("std", "residual", "delta")  # by increasing rho1 affinity


@dataclass(frozen=True)
class SelectorConfig:
    """Tuning knobs for :class:`ChannelSelector` (defaults are deliberately
    conservative: a stationary channel never switches)."""

    warmup_blocks: int = 8        # rolling-window length, in blocks
    hysteresis: float = 0.1       # rho1 margin to leave the current mode
    patience: int = 2             # consecutive evaluations before switching
    min_dwell_blocks: int = 64    # min blocks between switches (per channel)
    delta_rho: float = 0.7        # rho1 above which delta beats residual
    residual_rho: float = 0.35    # rho1 above which residual beats std
    drift_hi: float = 0.5         # non-stationarity level that tightens d_crit
    drift_lo: float = 0.2         # level below which the tightening relaxes
    # quantized d_crit multipliers (smallest = tightened); discrete levels
    # keep the per-channel threshold a small static set for jit caching
    d_crit_scales: Tuple[float, ...] = (0.75, 1.0)


@dataclass
class SelectionEvent:
    """One accepted switch, recorded in the session stats."""

    block_index: int
    old_mode: str
    new_mode: str
    old_scale: float
    new_scale: float
    rho1: float
    var_ratio: float
    range_drift: float

    def as_dict(self) -> dict:
        return {
            "block_index": self.block_index,
            "old_mode": self.old_mode, "new_mode": self.new_mode,
            "old_scale": self.old_scale, "new_scale": self.new_scale,
            "rho1": round(self.rho1, 4),
            "var_ratio": round(self.var_ratio, 4),
            "range_drift": round(self.range_drift, 4),
        }


class ChannelSelector:
    """Streaming per-channel statistics and the sticky mode/scale policy.

    ``observe(samples)`` after every feed keeps the rolling window current;
    ``decide(block_index)`` at a feed boundary returns a
    :class:`SelectionEvent` when a switch is accepted (and commits it), or
    ``None``.  The caller owns applying the switch (dictionary reset +
    restart segment).
    """

    def __init__(self, block_size: int, mode: str = "std",
                 config: Optional[SelectorConfig] = None):
        self.cfg = config or SelectorConfig()
        if self.cfg.warmup_blocks < 2:
            raise ValueError("warmup_blocks must be >= 2")
        if not self.cfg.d_crit_scales:
            raise ValueError("d_crit_scales must be non-empty")
        if mode not in _MODE_ORDER:
            raise ValueError(f"mode must be one of {_MODE_ORDER}")
        self.mode = mode
        self.scale = 1.0 if 1.0 in self.cfg.d_crit_scales \
            else self.cfg.d_crit_scales[-1]
        self._winlen = self.cfg.warmup_blocks * int(block_size)
        self._win = np.zeros(0, dtype=np.float64)
        self._ref = None  # (var, min, max) captured from the first full window
        self._pending = None
        self._streak = 0
        self._last_switch: Optional[int] = None
        self.events: List[SelectionEvent] = []

    # --------------------------------------------------------------- observe
    def observe(self, samples) -> None:
        """Fold raw (untransformed) samples into the rolling window."""
        x = np.asarray(samples, dtype=np.float64).ravel()
        if x.size:
            self._win = np.concatenate([self._win, x])[-self._winlen:]
        if self._ref is None and len(self._win) >= self._winlen:
            w = self._win
            self._ref = (float(np.var(w)), float(np.min(w)),
                         float(np.max(w)))

    def predictors(self) -> Optional[Tuple[float, float, float]]:
        """(rho1, var_ratio, range_drift) over the current window, or None
        while still warming up."""
        w = self._win
        if self._ref is None or len(w) < self._winlen:
            return None
        a, b = w[:-1], w[1:]
        va, vb = np.var(a), np.var(b)
        rho1 = 0.0 if va * vb == 0 else float(
            np.mean((a - a.mean()) * (b - b.mean())) / np.sqrt(va * vb))
        ref_var, ref_min, ref_max = self._ref
        var_ratio = float(np.var(w) / max(ref_var, 1e-30))
        width = max(ref_max - ref_min, 1e-30)
        drift = float(max(0.0, ref_min - np.min(w), np.max(w) - ref_max)
                      / width)
        return rho1, var_ratio, drift

    # ---------------------------------------------------------------- policy
    def _target_mode(self, rho1: float) -> str:
        """Rank by rho1 with sticky boundaries: a boundary the current mode
        already cleared moves *away* by the hysteresis margin."""
        cfg = self.cfg
        cur = _MODE_ORDER.index(self.mode)
        b1 = cfg.residual_rho + (cfg.hysteresis if cur < 1
                                 else -cfg.hysteresis)
        b2 = cfg.delta_rho + (cfg.hysteresis if cur < 2 else -cfg.hysteresis)
        return _MODE_ORDER[int(rho1 >= b1) + int(rho1 >= b2)]

    def _target_scale(self, var_ratio: float, drift: float) -> float:
        """Tighten d_crit (smallest quantized scale) while the channel is
        non-stationary; relax only once it settles (drift_lo < drift_hi is
        the hysteresis band)."""
        cfg = self.cfg
        sig = max(abs(float(np.log(max(var_ratio, 1e-30)))), drift)
        tight, normal = cfg.d_crit_scales[0], self.__class__._normal(cfg)
        if self.scale == normal:
            return tight if sig >= cfg.drift_hi else normal
        return normal if sig <= cfg.drift_lo else tight

    @staticmethod
    def _normal(cfg: SelectorConfig) -> float:
        return 1.0 if 1.0 in cfg.d_crit_scales else cfg.d_crit_scales[-1]

    def decide(self, block_index: int) -> Optional[SelectionEvent]:
        """Evaluate at a feed boundary; returns the accepted switch (already
        committed to ``self.mode``/``self.scale``) or None."""
        p = self.predictors()
        if p is None:
            return None
        cfg = self.cfg
        if (self._last_switch is not None
                and block_index - self._last_switch < cfg.min_dwell_blocks):
            return None
        rho1, var_ratio, drift = p
        target = (self._target_mode(rho1),
                  self._target_scale(var_ratio, drift))
        if target == (self.mode, self.scale):
            self._pending, self._streak = None, 0
            return None
        if target == self._pending:
            self._streak += 1
        else:
            self._pending, self._streak = target, 1
        if self._streak < cfg.patience:
            return None
        ev = SelectionEvent(block_index, self.mode, target[0], self.scale,
                            target[1], rho1, var_ratio, drift)
        self.mode, self.scale = target
        self._last_switch = block_index
        self._pending, self._streak = None, 0
        # re-arm the reference on the new regime: the next observe() call
        # recaptures it from the (already full) window
        self._ref = None
        self.events.append(ev)
        return ev
