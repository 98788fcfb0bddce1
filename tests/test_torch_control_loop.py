"""The port's control loop (``repro_torch.serve.control``) on the CPU.

Each test of the reference's ``tests/test_control_loop.py`` runs here
against the port: synthetic stage histograms on a scratch registry of the
port's ``obs`` drive every decision branch -- batch sizing against the
latency target, pipeline-depth switching on stage balance,
drift-triggered autotune re-probes, and the min-observation gate.  Then
the port's and the reference's loops, fed the same stage observations into
their own registries, must take equal decisions tick for tick.  No device
work: the loop reads histograms only.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro import obs as jax_obs  # noqa: E402
from repro.serve import FlushPolicy as JaxFlushPolicy  # noqa: E402
from repro.serve.control import ControlConfig as JaxControlConfig  # noqa: E402
from repro.serve.control import ControlLoop as JaxControlLoop  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import decode as decode_mod  # noqa: E402
from repro_torch.serve import FlushPolicy  # noqa: E402
from repro_torch.serve import control as control_mod  # noqa: E402
from repro_torch.serve.control import (STAGES, ControlConfig,  # noqa: E402
                                       ControlLoop)


def make_loop(policy=None, reg=None, fired=None, **cfg):
    reg = reg if reg is not None else obs.MetricsRegistry()
    hists = {s: reg.histogram("repro_serve_stage_seconds", "stage wall",
                              labels={"stage": s}) for s in STAGES}
    loop = ControlLoop(
        policy=policy or FlushPolicy(max_batch_blocks=4096, max_age_s=0.1),
        config=ControlConfig(min_observations=4, **cfg), registry=reg,
        on_reprobe=(lambda: fired.append(1)) if fired is not None
        else (lambda: None))
    return loop, hists


def observe(hists, n, host_s, reconstruct_s):
    for _ in range(n):
        for s, h in hists.items():
            h.observe(reconstruct_s if s == "reconstruct" else host_s)


def test_no_histograms_is_a_clean_noop():
    loop = ControlLoop(policy=FlushPolicy(),
                       registry=obs.MetricsRegistry(),
                       on_reprobe=lambda: None)
    d = loop.tick()
    assert not d.changed and not d.reprobed and d.p99_s is None


def test_below_min_observations_holds_policy():
    loop, hists = make_loop()
    observe(hists, 2, host_s=1.0, reconstruct_s=1.0)  # loud but sparse
    d = loop.tick()
    assert not d.changed and d.p99_s is None


def test_over_target_halves_batch_and_deadline():
    loop, hists = make_loop()
    observe(hists, 16, host_s=0.002, reconstruct_s=0.08)
    d = loop.tick()
    assert d.changed
    assert d.policy.max_batch_blocks == 2048
    assert d.policy.max_age_s == pytest.approx(0.05)
    assert any("max_batch_blocks" in r for r in d.reasons)


def test_under_watermark_doubles_back_up():
    loop, hists = make_loop()
    observe(hists, 16, host_s=0.0005, reconstruct_s=0.0005)
    d = loop.tick()
    assert d.changed and d.policy.max_batch_blocks == 8192
    assert d.policy.max_age_s == pytest.approx(0.2)


def test_batch_clamps_at_bounds():
    lo, hists = make_loop(policy=FlushPolicy(max_batch_blocks=256,
                                             max_age_s=0.002))
    observe(hists, 16, host_s=0.002, reconstruct_s=0.08)
    d = lo.tick()  # already at min_batch_blocks/min_age_s: nothing to halve
    assert d.policy.max_batch_blocks == 256
    assert d.policy.max_age_s == pytest.approx(0.002)

    hi, hists = make_loop(policy=FlushPolicy(max_batch_blocks=1 << 16,
                                             max_age_s=0.5))
    observe(hists, 16, host_s=0.0001, reconstruct_s=0.0001)
    d = hi.tick()
    assert d.policy.max_batch_blocks == 1 << 16
    assert d.policy.max_age_s == pytest.approx(0.5)


def test_pipeline_depth_follows_stage_balance():
    loop, hists = make_loop()
    # device stage dominates -> overlap pays -> depth 2
    observe(hists, 16, host_s=0.001, reconstruct_s=0.02)
    assert loop.tick().policy.pipeline_depth == 2
    # host dominates -> overlap is overhead -> back to 1
    observe(hists, 16, host_s=0.01, reconstruct_s=0.001)
    assert loop.tick().policy.pipeline_depth == 1


def test_drift_triggers_reprobe_against_best_baseline():
    fired = []
    loop, hists = make_loop(fired=fired)
    observe(hists, 16, host_s=0.0005, reconstruct_s=0.001)  # pins baseline
    assert not loop.tick().reprobed
    observe(hists, 16, host_s=0.0005, reconstruct_s=0.0005)  # improves it
    assert not loop.tick().reprobed
    observe(hists, 16, host_s=0.0005, reconstruct_s=0.005)   # 10x the best
    d = loop.tick()
    assert d.reprobed and fired == [1]
    assert any("re-probe" in r for r in d.reasons)


def test_reprobe_repins_baseline_no_thrash():
    fired = []
    loop, hists = make_loop(fired=fired)
    observe(hists, 16, host_s=0.0005, reconstruct_s=0.001)
    loop.tick()
    observe(hists, 16, host_s=0.0005, reconstruct_s=0.01)
    assert loop.tick().reprobed
    # the same (drifted) latency again is now the baseline: no second probe
    observe(hists, 16, host_s=0.0005, reconstruct_s=0.01)
    assert not loop.tick().reprobed
    assert fired == [1]


def test_interval_deltas_forget_history():
    loop, hists = make_loop()
    observe(hists, 64, host_s=0.002, reconstruct_s=0.08)  # slow era
    loop.tick()
    observe(hists, 16, host_s=0.0001, reconstruct_s=0.0001)  # fast era
    d = loop.tick()
    # a cumulative-quantile controller would still think we are slow
    assert d.p99_s < 0.01


def test_status_shape():
    loop, hists = make_loop()
    observe(hists, 16, host_s=0.002, reconstruct_s=0.08)
    loop.tick()
    st = loop.status()
    assert st["ticks"] == 1
    assert set(st["policy"]) == {"max_batch_blocks", "max_batch_streams",
                                 "max_age_s", "pipeline_depth"}
    assert st["last_p99_s"] > 0
    assert st["last_reasons"]


def test_decision_ring_is_bounded():
    loop, hists = make_loop()
    for _ in range(80):
        loop.tick()
    assert len(loop.decisions) == 64


def test_flush_policy_with_updates_and_as_dict():
    p = FlushPolicy(max_batch_blocks=100, max_age_s=0.5)
    q = p.with_updates(max_batch_blocks=50)
    assert (q.max_batch_blocks, q.max_age_s) == (50, 0.5)
    assert p.max_batch_blocks == 100  # frozen original untouched
    assert q.as_dict()["max_batch_blocks"] == 50


# ------------------------------------------------------- port vs reference
def _decision(d):
    return (d.policy.as_dict(), d.changed, d.reprobed, d.reasons, d.p99_s,
            d.stage_p99_s)


def test_port_and_reference_decide_alike_tick_for_tick():
    """The same seeded stage observations go into the port's registry and
    the reference's; both loops, from the same policy and setpoints, must
    emit equal decisions (policy, flags, reasons, quantiles) and equal
    ``status()`` documents at every tick -- across the latency, depth,
    clamp, drift and min-observation branches."""
    rng = np.random.default_rng(19)
    kw = dict(min_observations=4, min_batch_blocks=512,
              max_batch_blocks=1 << 14, min_age_s=0.004)
    fired, jfired = [], []
    reg, jreg = obs.MetricsRegistry(), jax_obs.MetricsRegistry()
    hists = {s: reg.histogram("repro_serve_stage_seconds", "stage wall",
                              labels={"stage": s}) for s in STAGES}
    jhists = {s: jreg.histogram("repro_serve_stage_seconds", "stage wall",
                                labels={"stage": s}) for s in STAGES}
    loop = ControlLoop(FlushPolicy(max_batch_blocks=4096, max_age_s=0.1),
                       ControlConfig(**kw), reg, lambda: fired.append(1))
    jloop = JaxControlLoop(JaxFlushPolicy(max_batch_blocks=4096,
                                          max_age_s=0.1),
                           JaxControlConfig(**kw), jreg,
                           lambda: jfired.append(1))
    # (observations, host seconds scale, reconstruct seconds scale) a tick
    eras = [(2, 1.0, 1.0), (16, 0.002, 0.08), (16, 0.002, 0.08),
            (16, 0.0005, 0.0005), (16, 0.001, 0.02), (16, 0.01, 0.001),
            (0, 0, 0), (16, 0.0005, 0.001), (16, 0.0005, 0.0004),
            (16, 0.0005, 0.01), (16, 0.0005, 0.01), (64, 1e-5, 1e-5),
            (64, 1e-5, 1e-5), (64, 1e-5, 1e-5), (5, 0.3, 2.0)]
    for k, (n, host, dev) in enumerate(eras):
        for _ in range(n):
            for s in STAGES:
                v = float((dev if s == "reconstruct" else host)
                          * rng.uniform(0.5, 1.5))
                hists[s].observe(v)
                jhists[s].observe(v)
        d, jd = loop.tick(), jloop.tick()
        assert _decision(d) == _decision(jd), k
        assert loop.status() == jloop.status(), k
    assert fired == jfired and fired  # the drift branch was taken
    assert {d.policy.pipeline_depth for d in loop.decisions} == {1, 2}


def test_default_reprobe_resets_the_ports_autotune(monkeypatch):
    calls = []
    monkeypatch.setattr(decode_mod, "reset_autotune",
                        lambda: calls.append(1))
    loop = ControlLoop(registry=obs.MetricsRegistry())
    assert loop._on_reprobe is control_mod._default_reprobe
    loop._on_reprobe()
    assert calls == [1]
