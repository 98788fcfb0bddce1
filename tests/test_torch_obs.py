"""Telemetry of the PyTorch port vs the JAX reference, on the CPU.

The port keeps its own registry and tracer (``repro_torch.obs``), a copy
of the reference's.  Held here: the instruments' semantics, exact totals
under concurrent writers, span nesting and ring eviction, the exporters'
round trip, the same Prometheus text as the reference for the same
operations, and the wiring: after the same encode, the port's encode
counters move by what the reference's move by.  Wiring tests read deltas
of the process-default registries, which other tests also write.
Tolerance: none (text and counts equal).
"""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import GOLDEN_CASES, golden_codec_kwargs, golden_signal  # noqa: E402
from repro import obs as jax_obs  # noqa: E402
from repro.core import IdealemCodec as JaxCodec  # noqa: E402
from repro_torch import IdealemCodec, obs  # noqa: E402
from repro_torch.core import decode as tdec  # noqa: E402
from repro_torch.core import encoder as tenc  # noqa: E402
from repro_torch.obs import MetricsRegistry, SpanTracer  # noqa: E402

ENCODE_KEYS = ("bytes_in", "bytes_out", "segments", "blocks", "hits")
MISS_REASONS = ("cold", "minmax", "ks", "error_bound")


# ------------------------------------------------------------ registry
def test_port_registry_is_not_the_reference_registry():
    assert obs.registry() is not jax_obs.registry()
    assert obs.tracer() is not jax_obs.tracer()
    assert obs.__all__ == jax_obs.__all__
    assert obs.DEFAULT_LATENCY_BUCKETS == jax_obs.DEFAULT_LATENCY_BUCKETS


def test_instruments_and_conflicts():
    reg = MetricsRegistry()
    c = reg.counter("t_ops_total", "ops")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("t_depth")
    g.set(4)
    g.inc()
    g.dec(2)
    assert g.value == 3.0
    assert reg.get_value("t_never_written_total") == 0.0
    assert reg.counter("t2_total", labels={"x": "1", "y": "2"}) is \
        reg.counter("t2_total", labels={"y": "2", "x": "1"})
    with pytest.raises(ValueError):
        reg.gauge("t_ops_total")
    reg.histogram("t_seconds", buckets=(0.1, 1.0))
    with pytest.raises(ValueError):
        reg.histogram("t_seconds", buckets=(0.5, 1.0))
    for bad in (lambda: reg.counter("bad name!"),
                lambda: reg.counter("t3_total", labels={"bad-label": "v"})):
        with pytest.raises(ValueError):
            bad()


def test_histogram_le_boundaries():
    h = MetricsRegistry().histogram("t_seconds", buckets=(0.1, 1.0, 10.0))
    for v in (0.1, 1.0, 10.0, 0.05, 10.0001):
        h.observe(v)
    assert h.bucket_counts() == (2, 1, 1, 1)
    assert h.count == 5


def test_reset_keeps_handles_and_disable_drops_writes():
    reg = MetricsRegistry()
    c, h = reg.counter("t_total"), reg.histogram("t_seconds")
    c.inc(7)
    h.observe(0.5)
    reg.reset()
    assert c.value == 0.0 and h.count == 0
    c.inc()
    assert reg.get_value("t_total") == 1.0
    reg.enabled = False
    c.inc(5)
    h.observe(1.0)
    assert c.value == 1.0 and h.count == 0
    prev = obs.set_enabled(False)
    try:
        assert not obs.registry().enabled
    finally:
        obs.set_enabled(prev)


def test_registry_thread_safety_exact_totals():
    reg = MetricsRegistry()
    shared = reg.counter("t_shared_total")
    hist = reg.histogram("t_lat_seconds")
    n_threads, n_iter = 8, 2000

    def worker(i):
        own = reg.counter("t_labeled_total", labels={"w": str(i)})
        for _ in range(n_iter):
            shared.inc()
            own.inc()
            hist.observe(1e-4)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert shared.value == n_threads * n_iter
    assert hist.count == n_threads * n_iter
    for i in range(n_threads):
        assert reg.get_value("t_labeled_total", {"w": str(i)}) == n_iter


# ------------------------------------------------------------ tracer
def test_span_nesting_error_status_and_events():
    trc = SpanTracer()
    with trc.span("outer") as outer_id:
        with trc.span("inner") as inner_id:
            trc.event("tick")
    recs = {r.name: r for r in trc.records()}
    assert recs["inner"].parent_id == outer_id
    assert recs["outer"].parent_id is None
    assert recs["tick"].parent_id == inner_id
    assert recs["tick"].kind == "event" and recs["tick"].duration_s == 0.0
    assert [r.name for r in trc.records()] == ["tick", "inner", "outer"]
    with pytest.raises(RuntimeError):
        with trc.span("boom"):
            raise RuntimeError("x")
    (rec,) = trc.records(name="boom")
    assert rec.status == "error"


def test_span_ring_eviction_and_disabled_tracer():
    trc = SpanTracer(capacity=3)
    for i in range(7):
        trc.event(f"e{i}")
    assert [r.name for r in trc.records()] == ["e4", "e5", "e6"]
    off = SpanTracer(enabled=False)
    with off.span("s") as sid:
        assert sid is None
    off.event("e")
    assert off.records() == []


def test_span_threads_nest_independently():
    trc = SpanTracer()

    def worker(tag):
        with trc.span(f"{tag}.outer"):
            with trc.span(f"{tag}.inner"):
                pass

    threads = [threading.Thread(target=worker, args=(f"t{i}",))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for i in range(4):
        (inner,) = trc.records(name=f"t{i}.inner")
        (outer,) = trc.records(name=f"t{i}.outer")
        assert inner.parent_id == outer.span_id


def test_exporters_that_raise_are_dropped():
    trc = SpanTracer()
    seen, calls = [], []

    def bad(rec):
        calls.append(rec.name)
        raise ValueError("poison")

    trc.add_exporter(lambda rec: seen.append(rec.name))
    trc.add_exporter(bad)
    trc.event("a")
    trc.event("b")
    assert seen == ["a", "b"] and calls == ["a"]


# ------------------------------------------------------------ exporters
def _same_operations(mod):
    """One sequence of registry operations, on ``mod``'s registry type."""
    reg = mod.MetricsRegistry()
    reg.counter("t_ops_total", "ops", labels={"op": "read"}).inc(2)
    reg.counter("t_ops_total", labels={"op": 'we"ird\\\n'}).inc(0.25)
    reg.gauge("t_depth").set(1.5)
    reg.gauge("t_neg").dec(3)
    h = reg.histogram("t_lat_seconds", "lat", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    d = reg.histogram("t_default_seconds")
    for v in (1e-6, 3e-4, 0.25, 99.0):
        d.observe(v)
    return reg


def test_prometheus_text_equals_reference():
    reg, ref = _same_operations(obs), _same_operations(jax_obs)
    text = obs.to_prometheus(reg)
    assert text == jax_obs.to_prometheus(ref)
    assert obs.parse_prometheus(text) == jax_obs.parse_prometheus(text)
    assert reg.snapshot() == ref.snapshot()
    assert text.startswith("# TYPE t_default_seconds histogram\n")


def test_json_snapshot_and_selfcheck():
    reg = _same_operations(obs)
    trc = SpanTracer()
    with trc.span("s"):
        pass
    doc = obs.to_json(reg, trc)
    assert doc["version"] == 1 and doc["spans"][0]["name"] == "s"
    json.loads(json.dumps(doc))
    assert obs.selfcheck() == []
    assert obs.selfcheck(reg, trc) == []
    assert obs.selfcheck(obs.registry()) == []


def test_quantiles_and_slos_equal_reference():
    reg, ref = _same_operations(obs), _same_operations(jax_obs)
    for q in (0.0, 0.5, 0.9, 1.0):
        assert obs.quantile("t_default_seconds", q, reg=reg) == \
            jax_obs.quantile("t_default_seconds", q, reg=ref)
    parsed = obs.parse_prometheus(obs.to_prometheus(reg))
    assert obs.quantile_from_parsed(parsed, "t_lat_seconds", 0.5) == \
        obs.quantile("t_lat_seconds", 0.5, reg=reg)
    specs = [obs.SloSpec("t_lat_seconds", 0.5, 0.2),
             obs.SloSpec("t_lat_seconds", 0.99, 0.2),
             obs.SloSpec("t_absent_seconds", 0.5, 0.1)]
    got = [(r.value, r.ok, r.describe()) for r in
           obs.evaluate_slos(specs, reg=reg)]
    want = [(r.value, r.ok, r.describe()) for r in jax_obs.evaluate_slos(
        [jax_obs.SloSpec(s.name, s.quantile, s.max_value) for s in specs],
        reg=ref)]
    assert got == want
    assert [ok for _, ok, _ in got] == [False, False, True]
    with pytest.raises(ValueError):
        obs.histogram_quantile((1.0,), (1, 0), 1.5)


# ------------------------------------------------------------ wiring
def _key(name, **labels):
    return name, tuple(sorted(labels.items()))


def _deltas(reg, fn, keys):
    """``{key: growth}`` of each ``(name, label items)`` over ``fn()``."""
    def value(k):
        return reg.get_value(k[0], dict(k[1]))

    before = {k: value(k) for k in keys}
    fn()
    return {k: value(k) - v for k, v in before.items()}


def _encode(codec, x, feed=100):
    s = codec.session()
    for lo in range(0, len(x), feed):
        s.feed(x[lo:lo + feed])
    return s.finish()


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_encode_counters_equal_reference(name):
    """After the same numpy-backend session, the port's encode counters
    and miss reasons move by exactly what the reference's move by."""
    kw = golden_codec_kwargs(name)
    x = golden_signal(name)
    names = ([_key(f"repro_encode_{k}_total") for k in ENCODE_KEYS]
             + [_key("repro_encode_miss_total", reason=r)
                for r in MISS_REASONS])
    got = _deltas(obs.registry(), lambda: _encode(
        IdealemCodec(device="cpu", **kw), x), names)
    want = _deltas(jax_obs.registry(), lambda: _encode(JaxCodec(**kw), x),
                   names)
    assert got == want
    blocks = got[_key("repro_encode_blocks_total")]
    assert blocks == len(x) // 16
    assert sum(got[_key("repro_encode_miss_total", reason=r)]
               for r in MISS_REASONS) == \
        blocks - got[_key("repro_encode_hits_total")]


def test_error_bound_misses_are_attributed():
    x = golden_signal("std_D32")
    kw = dict(golden_codec_kwargs("std_D32"), error_bound=0.05)
    key = _key("repro_encode_miss_total", reason="error_bound")
    got = _deltas(obs.registry(), lambda: _encode(
        IdealemCodec(device="cpu", **kw), x), [key])
    want = _deltas(jax_obs.registry(), lambda: _encode(JaxCodec(**kw), x),
                   [key])
    assert got == want and got[key] > 0


def test_decode_counters_by_backend():
    blob = IdealemCodec(mode="delta", block_size=16, num_dict=4,
                        backend="numpy", device="cpu").encode(
        golden_signal("delta_D32"))
    reg = obs.registry()
    names = [_key("repro_decode_backend_calls_total", backend=b)
             for b in ("numpy", "torch", "cuda")]
    stats0 = tdec.decode_stats()

    def run():
        for b in ("numpy", "torch", "cuda", "cuda"):
            IdealemCodec(device="cpu").decode(blob, backend=b)

    got = _deltas(reg, run, names)
    assert list(got.values()) == [1, 1, 2]
    stats = tdec.decode_stats()
    assert set(stats) == {"host_calls", "device_calls", "autotune_probes",
                          "autotune_hits", "autotune_choices"}
    assert stats["host_calls"] - stats0["host_calls"] == 1
    assert stats["device_calls"] - stats0["device_calls"] == 3
    assert reg.get_value("repro_decode_host_calls_total") == \
        stats["host_calls"]
    tdec.reset_decode_stats()
    assert tdec.decode_stats() == {
        "host_calls": 0, "device_calls": 0, "autotune_probes": 0,
        "autotune_hits": 0, "autotune_choices": tdec.autotune_choices()}
    assert reg.get_value("repro_decode_backend_calls_total",
                         {"backend": "cuda"}) == 0


def test_tuner_counters_on_the_registry():
    tenc.reset_encode_autotune()
    reg = obs.registry()
    labels = {"tuner": "encode"}
    pt = torch.as_tensor(np.random.default_rng(0).normal(
        0, 1, (2, 4, 16)), dtype=torch.float32)
    kw = dict(num_dict=4, d_crit=0.5, rel_tol=0.5, matcher="auto")
    tenc.encode_decisions_batched(pt, **kw)
    tenc.encode_decisions_batched(pt, **kw)
    assert reg.get_value("repro_tuning_probes_total", labels) == 1
    assert reg.get_value("repro_tuning_hits_total", labels) >= 1
    assert tenc._TUNER.stats["probes"] == 1


def test_adaptive_dispatches_and_mode_switch_events():
    rng = np.random.default_rng(3)
    n = 16 * 48
    x = np.stack([rng.normal(0, 1, n),
                  np.sin(np.arange(n) * 0.01) * 5 + rng.normal(0, 0.01, n)])
    codec = IdealemCodec(mode="std", block_size=16, num_dict=8, alpha=0.05,
                         adaptive=True, backend="torch", device="cpu")
    reg = obs.registry()
    names = [_key("repro_encode_dispatches_total", path="adaptive_batched"),
             _key("repro_encode_mode_switches_total")]
    events0 = len(obs.tracer().records(name="encode.mode_switch"))
    s = codec.session(channels=2)
    feeds = 0

    def run():
        nonlocal feeds
        for lo in range(0, n, 64):
            s.feed(x[:, lo:lo + 64])
            feeds += 1
        s.finish()

    got = _deltas(reg, run, names)
    switches = sum(st.mode_switches for st in s.stats)
    assert switches > 0
    assert got[names[0]] == feeds
    assert got[names[1]] == switches
    events = obs.tracer().records(name="encode.mode_switch")[events0:]
    assert len(events) == switches
    assert {e.attrs["channel"] for e in events} <= {0, 1}
    assert "new_mode" in events[0].attrs
