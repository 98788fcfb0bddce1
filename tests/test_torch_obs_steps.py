"""The port's step telemetry, on the CPU: ``obs.span(..., seconds=)``, the
coalescer flush's ``encode.<step>`` spans and
``repro_encode_flush_step_seconds`` children, its padded cells, the
device decode's ``decode.<step>`` spans, ``repro_decode_step_seconds``
children and requested / dispatched rows, and the chunk walk's histogram.

Held here: each step is one child span of its parent (by ``parent_id``)
and one histogram observation a flush or dispatch, the steps' sum stays
inside the parent's, the counters equal the shapes the flush and the
dispatch really made, a disabled tracer records nothing while every
histogram and counter still moves, and the records a flush adds do not
grow with its streams.  Wiring tests read deltas of the process-default
registry, which other tests also write.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import IdealemCodec  # noqa: E402
from repro_torch.core.select import SelectorConfig  # noqa: E402
from repro_torch.obs import MetricsRegistry, SpanTracer  # noqa: E402
from repro_torch.serve import (DecompressionService, FlushPolicy,  # noqa: E402
                               StreamCoalescer)

B = 16
ENC_STEPS = ("take", "prepare", "stage", "h2d", "scan", "d2h", "commit")
ADAPTIVE_STEPS = ("take", "prepare", "scan", "commit")
DEC_STEPS = ("perms", "h2d", "launch", "d2h")
KW = dict(mode="std", block_size=B, num_dict=8)


def _hist(name, **labels):
    """(sum, count) of one histogram child of the default registry."""
    for v in obs.registry().snapshot()[name]["values"]:
        if v["labels"] == labels:
            return v["sum"], v["count"]
    return 0.0, 0


def _count(name, **labels):
    return obs.registry().get_value(name, labels or None)


def _spans_since(t0):
    return [r for r in obs.tracer().records(kind="span") if r.start_s >= t0]


def _signal(streams, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, 1.0, size=(streams, n)).cumsum(axis=1) * 0.1


def _coalescer(capacity=4, **kw):
    return StreamCoalescer(policy=FlushPolicy(max_batch_blocks=10 ** 9),
                           capacity=capacity, block_bucket=8,
                           backend="torch", device="cpu", **{**KW, **kw})


def _one_flush(co, data):
    for k in range(len(data)):
        co.open_stream(f"s{k}")
    for k, x in enumerate(data):
        assert co.submit(f"s{k}", x) is None
    return co.flush()


# ------------------------------------------------------------ obs.span
def test_span_seconds_observes_on_success_only():
    reg, trc = MetricsRegistry(), SpanTracer()
    h = reg.histogram("t_step_seconds")
    with trc.span("ok", seconds=h):
        time.sleep(0.001)
    (rec,) = trc.records()
    assert h.count == 1 and h.sum == rec.duration_s >= 0.001
    with pytest.raises(ValueError):
        with trc.span("bad", seconds=h):
            raise ValueError
    assert h.count == 1 and trc.records()[-1].status == "error"


def test_span_seconds_is_switched_by_the_registry_not_the_tracer():
    reg, trc = MetricsRegistry(), SpanTracer(enabled=False)
    h = reg.histogram("t_step_seconds")
    with trc.span("off", seconds=h) as sid:
        assert sid is None
    assert trc.records() == [] and h.count == 1
    with pytest.raises(KeyError):
        with trc.span("off", seconds=h):
            raise KeyError
    assert h.count == 1
    reg.enabled = False
    trc.enabled = True
    with trc.span("on", seconds=h):
        pass
    assert len(trc.records()) == 1 and h.count == 1


# ------------------------------------------------------ coalescer flush
def test_flush_steps_are_children_of_encode_flush():
    data = _signal(3, 5 * B + 3)
    co = _coalescer()
    for k in range(3):
        co.open_stream(f"s{k}")
    for k, x in enumerate(data):
        co.submit(f"s{k}", x)
    step0 = {s: _hist("repro_encode_flush_step_seconds", step=s)
             for s in ENC_STEPS}
    flush0 = _hist("repro_encode_flush_seconds")
    cells0 = _count("repro_encode_flush_cells_total")
    blocks0 = _hist("repro_encode_flush_blocks")
    t0 = time.perf_counter()
    out = co.flush()
    assert set(out) == {"s0", "s1", "s2"}
    recs = _spans_since(t0)
    (flush,) = [r for r in recs if r.name == "encode.flush"]
    kids = [r for r in recs if r.parent_id == flush.span_id]
    assert sorted(r.name for r in kids) == sorted(
        f"encode.{s}" for s in ENC_STEPS)
    assert [r.name for r in sorted(kids, key=lambda r: r.start_s)] == [
        f"encode.{s}" for s in ENC_STEPS]
    grown = {s: tuple(a - b for a, b in zip(
        _hist("repro_encode_flush_step_seconds", step=s), step0[s]))
        for s in ENC_STEPS}
    assert all(n == 1 for _, n in grown.values())
    flush_s = _hist("repro_encode_flush_seconds")[0] - flush0[0]
    assert 0 < sum(t for t, _ in grown.values()) <= flush_s
    for r in kids:
        assert grown[r.name.split(".")[1]][0] == pytest.approx(r.duration_s)
    # 5 blocks a stream, bucketed to 8, over 4 slots
    assert _count("repro_encode_flush_cells_total") - cells0 == 4 * 8
    assert _hist("repro_encode_flush_blocks")[0] - blocks0[0] == 3 * 5


def test_flush_cells_follow_the_slot_table_and_the_bucket():
    co = _coalescer(capacity=2)
    cells0 = _count("repro_encode_flush_cells_total")
    _one_flush(co, _signal(3, 9 * B))   # 3 streams grow the table to 4
    assert co.capacity == 4
    assert _count("repro_encode_flush_cells_total") - cells0 == 4 * 16


def test_adaptive_flush_records_its_steps():
    co = _coalescer(adaptive=True, selector=SelectorConfig(warmup_blocks=4))
    data = _signal(2, 6 * B, seed=3)
    for k in range(2):
        co.open_stream(f"s{k}")
    for k, x in enumerate(data):
        co.submit(f"s{k}", x)
    step0 = {s: _hist("repro_encode_flush_step_seconds", step=s)[1]
             for s in ENC_STEPS}
    cells0 = _count("repro_encode_flush_cells_total")
    t0 = time.perf_counter()
    assert set(co.flush()) == {"s0", "s1"}
    recs = _spans_since(t0)
    (flush,) = [r for r in recs if r.name == "encode.flush"]
    kids = sorted((r for r in recs if r.parent_id == flush.span_id),
                  key=lambda r: r.start_s)
    assert [r.name for r in kids] == [f"encode.{s}" for s in ADAPTIVE_STEPS]
    assert {s: _hist("repro_encode_flush_step_seconds", step=s)[1]
            - step0[s] for s in ENC_STEPS} == {
        s: int(s in ADAPTIVE_STEPS) for s in ENC_STEPS}
    assert _count("repro_encode_flush_cells_total") - cells0 == 4 * 8


@pytest.mark.parametrize("streams", [4, 64])
def test_records_per_flush_do_not_grow_with_streams(streams):
    co = _coalescer(capacity=streams)
    data = _signal(streams, 3 * B, seed=streams)
    for k in range(streams):
        co.open_stream(f"s{k}")
    for k, x in enumerate(data):
        co.submit(f"s{k}", x)
    t0 = time.perf_counter()
    assert len(co.flush()) == streams
    names = sorted(r.name for r in obs.tracer().records()
                   if r.start_s >= t0)
    assert names == sorted(["encode.flush"]
                           + [f"encode.{s}" for s in ENC_STEPS])


# ------------------------------------------------------- decode dispatch
def _archive(channels=1, samples=40 * B, seed=5):
    codec = IdealemCodec(backend="torch", device="cpu", **KW)
    sess = codec.session(channels=channels, container=True)
    x = _signal(channels, samples, seed=seed)
    for a in range(0, samples, 8 * B):
        sess.feed(x[:, a:a + 8 * B])
    return sess.finish()


def test_read_records_decode_steps_under_reconstruct():
    svc = DecompressionService(policy=FlushPolicy(max_batch_streams=3),
                               backend="torch", device="cpu")
    svc.attach("a", _archive())
    step0 = {s: _hist("repro_decode_step_seconds", step=s)
             for s in DEC_STEPS}
    rows0 = {k: _count("repro_decode_rows_total", kind=k)
             for k in ("requested", "dispatched")}
    walks0 = _count("repro_store_chunk_walks_total")
    walk0 = _hist("repro_store_chunk_walk_seconds")
    t0 = time.perf_counter()
    assert svc.submit("r0", "a", 0, 3) is None
    assert svc.submit("r1", "a", 5, 12) is None
    out = svc.submit("r2", "a", 20, 22)
    assert set(out) == {"r0", "r1", "r2"}
    recs = _spans_since(t0)
    (rec,) = [r for r in recs if r.name == "serve.reconstruct"]
    kids = sorted((r for r in recs if r.parent_id == rec.span_id),
                  key=lambda r: r.start_s)
    assert [r.name for r in kids] == ["decode.perms", "decode.h2d",
                                      "decode.launch", "decode.d2h"]
    grown = {s: tuple(a - b for a, b in zip(
        _hist("repro_decode_step_seconds", step=s), step0[s]))
        for s in DEC_STEPS}
    assert all(n == 1 for _, n in grown.values())
    assert sum(t for t, _ in grown.values()) <= rec.duration_s
    # 3 + 7 + 2 blocks requested, padded to 3 x 7 and then to 32
    assert _count("repro_decode_rows_total", kind="requested") \
        - rows0["requested"] == 12
    assert _count("repro_decode_rows_total", kind="dispatched") \
        - rows0["dispatched"] == 32
    walks = _count("repro_store_chunk_walks_total") - walks0
    walk = [a - b for a, b in zip(_hist("repro_store_chunk_walk_seconds"),
                                  walk0)]
    assert walks >= 1 and walk[1] == walks and walk[0] > 0
    svc.close()


def test_host_path_counts_no_device_rows():
    svc = DecompressionService(backend="numpy")
    svc.attach("a", _archive())
    rows0 = _count("repro_decode_rows_total", kind="dispatched")
    perms0 = _hist("repro_decode_step_seconds", step="perms")[1]
    assert len(svc.read("a", 0, 9)) == 9 * B
    assert _count("repro_decode_rows_total", kind="dispatched") == rows0
    assert _hist("repro_decode_step_seconds", step="perms")[1] == perms0


# ------------------------------------------------------- tracer disabled
def test_disabled_tracer_records_nothing_but_metrics_move():
    co = _coalescer()
    svc = DecompressionService(policy=FlushPolicy(max_batch_streams=2),
                               backend="torch", device="cpu")
    svc.attach("a", _archive(seed=9))
    data = _signal(2, 4 * B, seed=7)
    enc0 = {s: _hist("repro_encode_flush_step_seconds", step=s)[1]
            for s in ENC_STEPS}
    dec0 = {s: _hist("repro_decode_step_seconds", step=s)[1]
            for s in DEC_STEPS}
    stage0 = _hist("repro_serve_stage_seconds", stage="reconstruct")[1]
    cells0 = _count("repro_encode_flush_cells_total")
    rows0 = _count("repro_decode_rows_total", kind="requested")
    walk0 = _hist("repro_store_chunk_walk_seconds")[1]
    trc = obs.tracer()
    n0, was = len(trc.records()), trc.enabled
    trc.enabled = False
    try:
        t0 = time.perf_counter()
        _one_flush(co, data)
        svc.submit("r0", "a", 0, 4)
        assert set(svc.submit("r1", "a", 10, 13)) == {"r0", "r1"}
    finally:
        trc.enabled = was
    assert [r for r in trc.records() if r.start_s >= t0] == []
    assert len(trc.records()) == min(n0, trc.capacity)
    assert all(_hist("repro_encode_flush_step_seconds", step=s)[1]
               - enc0[s] == 1 for s in ENC_STEPS)
    assert all(_hist("repro_decode_step_seconds", step=s)[1] - dec0[s] == 1
               for s in DEC_STEPS)
    assert _hist("repro_serve_stage_seconds", stage="reconstruct")[1] \
        - stage0 == 1
    assert _count("repro_encode_flush_cells_total") - cells0 == 4 * 8
    assert _count("repro_decode_rows_total", kind="requested") - rows0 == 7
    assert _hist("repro_store_chunk_walk_seconds")[1] > walk0
    svc.close()
