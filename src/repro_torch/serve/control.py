"""Closed control loop: steer ``FlushPolicy`` from live telemetry.

``pipeline_depth``, ``max_batch_blocks`` and ``max_age_s`` are policy
knobs, and the read service exports its per-stage flush latencies
(``repro_serve_stage_seconds{stage=plan|gather|reconstruct|emit}``) into
the port's registry (``repro_torch.obs``).  This module closes the loop,
as the reference package's does: every :meth:`ControlLoop.tick`
reads the *interval* latency distribution (bucket-count deltas since the
previous tick -- cumulative histograms never forget, the controller must),
estimates stage quantiles (``repro_torch.obs.histogram_quantile``, the same
math the SLO gate uses), and moves the knobs:

* **latency**: when the summed per-stage p99 exceeds ``target_p99_s``,
  halve ``max_batch_blocks`` and ``max_age_s`` (smaller batches, earlier
  deadlines); when it sits below ``low_watermark * target``, double them
  back up (amortization) -- both clamped to configured bounds.
* **overlap**: when the device stage (reconstruct) p50 dominates the
  summed host stages p50 by ``depth_on_ratio``, raise ``pipeline_depth``
  to 2 (host planning of batch N+1 overlaps device reconstruct of N,
  DESIGN.md Sec. 9); otherwise drop back to 1 (the overlap thread is pure
  overhead when the host dominates).
* **drift**: the first healthy tick pins a reconstruct-p50 baseline; when
  the live p50 drifts beyond ``drift_factor`` of it, the measured
  autotune choices are stale (thermal change, contending tenant, new
  hardware) -- ``on_reprobe`` fires (default:
  ``repro_torch.core.decode.reset_autotune``) and the baseline re-pins.

The loop is a plain synchronous object with an injectable registry, so
unit tests drive it from synthetic histograms; the front end
(``repro_torch.serve.frontend``) ticks it on its timer and broadcasts the new
policy to every tenant's coalescers and decode services.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

from .. import obs

from .engine import FlushPolicy

__all__ = ["ControlConfig", "ControlDecision", "ControlLoop", "STAGES"]

STAGES = ("plan", "gather", "reconstruct", "emit")

_M_TICKS = obs.registry().counter(
    "repro_control_ticks_total", "control loop evaluations")
_M_ADJUST = {
    knob: obs.registry().counter(
        "repro_control_adjustments_total",
        "policy knob movements by the control loop",
        labels={"knob": knob})
    for knob in ("max_batch_blocks", "max_age_s", "pipeline_depth")
}
_M_REPROBE = obs.registry().counter(
    "repro_control_reprobes_total",
    "autotune re-probes triggered by latency drift")
_M_P99 = obs.registry().gauge(
    "repro_control_p99_seconds",
    "summed per-stage p99 at the last control tick")
_M_KNOB = {
    knob: obs.registry().gauge(
        f"repro_control_{knob}", f"current FlushPolicy {knob}")
    for knob in ("max_batch_blocks", "pipeline_depth")
}


@dataclass(frozen=True)
class ControlConfig:
    """Setpoints and actuator bounds of the loop."""

    target_p99_s: float = 0.050      # summed stage p99 budget per flush
    low_watermark: float = 0.25      # p99 below target*this => batch up
    min_batch_blocks: int = 256
    max_batch_blocks: int = 1 << 16
    min_age_s: float = 0.002
    max_age_s: float = 0.500
    depth_on_ratio: float = 1.2      # reconstruct p50 / host-stages p50
    drift_factor: float = 2.0        # reconstruct p50 vs pinned baseline
    min_observations: int = 8        # interval flushes needed to act


@dataclass(frozen=True)
class ControlDecision:
    """One tick's outcome: the (possibly new) policy and why."""

    policy: FlushPolicy
    changed: bool
    reprobed: bool
    reasons: Tuple[str, ...]
    p99_s: Optional[float]                   # summed stage p99, or None
    stage_p99_s: Dict[str, Optional[float]] = field(default_factory=dict)


class ControlLoop:
    """See the module docstring.  One instance per policy domain (the
    front end runs one and broadcasts); ``tick()`` is cheap enough for a
    sub-second timer."""

    def __init__(self, policy: Optional[FlushPolicy] = None,
                 config: Optional[ControlConfig] = None,
                 registry: Optional[obs.MetricsRegistry] = None,
                 on_reprobe: Optional[Callable[[], None]] = None):
        self.config = config or ControlConfig()
        self.policy = policy if policy is not None else FlushPolicy(
            max_age_s=self.config.max_age_s / 10)
        self._reg = registry if registry is not None else obs.registry()
        self._on_reprobe = (on_reprobe if on_reprobe is not None
                            else _default_reprobe)
        self._prev_counts: Dict[str, Tuple[int, ...]] = {}
        self._baseline_p50: Optional[float] = None
        self.ticks = 0
        self.decisions: list = []  # ControlDecision ring (bounded)

    # ------------------------------------------------------------- sampling
    def _stage_child(self, stage: str):
        for fam in self._reg.families():
            if fam.name == "repro_serve_stage_seconds" \
                    and fam.kind == "histogram":
                return fam.children.get((("stage", stage),))
        return None

    def _interval_counts(self, stage: str):
        """Per-bucket observation deltas since the previous tick (the
        controller steers on recent traffic, not the process lifetime)."""
        child = self._stage_child(stage)
        if child is None:
            return None, None
        counts = child.bucket_counts()
        prev = self._prev_counts.get(stage)
        self._prev_counts[stage] = counts
        if prev is None or len(prev) != len(counts):
            delta = counts  # first sight: the whole history is "recent"
        else:
            delta = tuple(c - p for c, p in zip(counts, prev))
        return child.bounds, delta

    # ----------------------------------------------------------------- tick
    def tick(self) -> ControlDecision:
        _M_TICKS.inc()
        self.ticks += 1
        cfg = self.config
        bounds_counts = {s: self._interval_counts(s) for s in STAGES}
        p99 = {}
        p50 = {}
        n_obs = {}
        for s, (bounds, delta) in bounds_counts.items():
            if bounds is None:
                p99[s] = p50[s] = None
                n_obs[s] = 0
                continue
            n_obs[s] = sum(delta)
            p99[s] = obs.histogram_quantile(bounds, delta, 0.99)
            p50[s] = obs.histogram_quantile(bounds, delta, 0.50)

        reasons = []
        reprobed = False
        pol = self.policy
        flushes = n_obs["reconstruct"]
        if flushes >= cfg.min_observations:
            total_p99 = sum(v for v in p99.values() if v is not None)
            _M_P99.set(total_p99)
            # -- latency vs target ------------------------------------------
            if total_p99 > cfg.target_p99_s:
                nb = max(cfg.min_batch_blocks, pol.max_batch_blocks // 2)
                if nb != pol.max_batch_blocks:
                    pol = pol.with_updates(max_batch_blocks=nb)
                    _M_ADJUST["max_batch_blocks"].inc()
                    reasons.append(
                        f"p99 {total_p99:.4f}s > target "
                        f"{cfg.target_p99_s:.4f}s: max_batch_blocks -> {nb}")
                if pol.max_age_s is not None:
                    age = max(cfg.min_age_s, pol.max_age_s / 2)
                    if age != pol.max_age_s:
                        pol = pol.with_updates(max_age_s=age)
                        _M_ADJUST["max_age_s"].inc()
                        reasons.append(f"max_age_s -> {age:.4f}")
            elif total_p99 < cfg.low_watermark * cfg.target_p99_s:
                nb = min(cfg.max_batch_blocks, pol.max_batch_blocks * 2)
                if nb != pol.max_batch_blocks:
                    pol = pol.with_updates(max_batch_blocks=nb)
                    _M_ADJUST["max_batch_blocks"].inc()
                    reasons.append(
                        f"p99 {total_p99:.4f}s under watermark: "
                        f"max_batch_blocks -> {nb}")
                if pol.max_age_s is not None:
                    age = min(cfg.max_age_s, pol.max_age_s * 2)
                    if age != pol.max_age_s:
                        pol = pol.with_updates(max_age_s=age)
                        _M_ADJUST["max_age_s"].inc()
                        reasons.append(f"max_age_s -> {age:.4f}")
            # -- pipeline depth from stage balance --------------------------
            host = [p50[s] for s in ("plan", "gather", "emit")]
            dev = p50["reconstruct"]
            if dev is not None and all(h is not None for h in host):
                host_sum = sum(host)
                want = 2 if dev > cfg.depth_on_ratio * host_sum else 1
                if want != pol.pipeline_depth:
                    pol = pol.with_updates(pipeline_depth=want)
                    _M_ADJUST["pipeline_depth"].inc()
                    reasons.append(
                        f"reconstruct p50 {dev:.4f}s vs host "
                        f"{host_sum:.4f}s: pipeline_depth -> {want}")
            # -- drift => autotune re-probe ---------------------------------
            # the baseline tracks the BEST reconstruct p50 seen since the
            # last re-probe ("what this pipeline can do"); drifting a
            # factor above it means the measured autotune choices went
            # stale, not that one tick was busy
            if dev is not None:
                if self._baseline_p50 is None:
                    self._baseline_p50 = dev
                elif dev > cfg.drift_factor * self._baseline_p50:
                    reprobed = True
                    _M_REPROBE.inc()
                    reasons.append(
                        f"reconstruct p50 drifted {dev:.4f}s vs baseline "
                        f"{self._baseline_p50:.4f}s: autotune re-probe")
                    self._baseline_p50 = dev
                    self._on_reprobe()
                else:
                    self._baseline_p50 = min(self._baseline_p50, dev)
            total = total_p99
        else:
            total = None

        changed = pol is not self.policy
        self.policy = pol
        _M_KNOB["max_batch_blocks"].set(pol.max_batch_blocks)
        _M_KNOB["pipeline_depth"].set(pol.pipeline_depth)
        decision = ControlDecision(policy=pol, changed=changed,
                                   reprobed=reprobed,
                                   reasons=tuple(reasons), p99_s=total,
                                   stage_p99_s=p99)
        self.decisions.append(decision)
        del self.decisions[:-64]
        return decision

    def status(self) -> dict:
        """JSON-ready controller state (``GET /v1/control``)."""
        last = self.decisions[-1] if self.decisions else None
        return {
            "ticks": self.ticks,
            "policy": self.policy.as_dict(),
            "target_p99_s": self.config.target_p99_s,
            "last_p99_s": None if last is None else last.p99_s,
            "last_reasons": [] if last is None else list(last.reasons),
            "baseline_reconstruct_p50_s": self._baseline_p50,
        }


def _default_reprobe() -> None:
    """Forget the measured decode-backend choices so the next dispatches
    re-time numpy/torch/cuda under the drifted conditions."""
    from ..core import decode as decode_mod
    decode_mod.reset_autotune()
