"""The port's read service, its stage pipeline and the decode autotune vs
the JAX reference, on the CPU.

``DecompressionService`` answers must equal the reference's
``DecompressionService(backend="numpy")`` and the slices of
``decode_stream``, bitwise; its dispatch counts and ``stats`` dicts must
equal the reference's under the same ``FlushPolicy`` (two stores merged,
host buckets, the pathological re-split, the chunk LRU, detach, a failing
group, the deadline).  The reference's ``jax`` backend routes like a
device backend but reconstructs on the host on this jax (its x64 import
fails), so its answers are ``_reconstruct_numpy``'s.  The pipeline's stage
order is proven with a lazy fake executor whose futures run only when
collected.  The decode autotune (``backend="auto"``) is held to the
reference's cache contract, with one difference: a device backend whose
probe bytes differ raises instead of being excluded.  The port's tensor
backends run on ``device="cpu"`` (K2's plain version).  Tolerance: none.
"""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import (GOLDEN_BLOCK, GOLDEN_CASES, golden_codec_kwargs,  # noqa: E402
                      golden_signal)
from repro import obs as jax_obs  # noqa: E402
from repro.core import IdealemCodec as JaxCodec  # noqa: E402
from repro.core.stream import decode_stream as jax_decode_stream  # noqa: E402
from repro.serve import DecompressionService as JaxDecompressionService  # noqa: E402
from repro.serve import FlushPolicy as JaxFlushPolicy  # noqa: E402
from repro.serve import StreamCoalescer as JaxStreamCoalescer  # noqa: E402
from repro.store import pack as jax_pack  # noqa: E402
from repro_torch import api, obs  # noqa: E402
from repro_torch.core import decode as decode_mod  # noqa: E402
from repro_torch.core import stream as stream_mod  # noqa: E402
from repro_torch.errors import StreamFormatError  # noqa: E402
from repro_torch.kernels import seq_cumsum as k2  # noqa: E402
from repro_torch.serve import (DecompressionService, FlushPolicy,  # noqa: E402
                               StageFuture, StagePipeline, StreamCoalescer,
                               SyncExecutor, ThreadStageExecutor)
from repro_torch.store import Container, pack  # noqa: E402

B = GOLDEN_BLOCK
FEED = 100
BACKENDS = ["numpy", "torch", "cuda"]
TWINS = {"numpy": "numpy", "torch": "jax", "cuda": "jax"}

_PREPPED = {}


def _session_stream(name, feed=FEED):
    codec = JaxCodec(**golden_codec_kwargs(name))
    x = golden_signal(name)
    s = codec.session()
    segs = [s.feed(x[lo:lo + feed]) for lo in range(0, len(x), feed)]
    segs.append(s.finish())
    return b"".join(segs)


def _prepped(name, feed=FEED):
    """(packed container bytes, the reference's full decode)."""
    if (name, feed) not in _PREPPED:
        blob = _session_stream(name, feed)
        _PREPPED[name, feed] = (jax_pack(blob), jax_decode_stream(blob))
    return _PREPPED[name, feed]


def _port(backend="numpy", executor=None, **kw):
    pol = {k: kw.pop(k) for k in list(kw) if k in FlushPolicy.__annotations__}
    return DecompressionService(policy=FlushPolicy(**pol), backend=backend,
                                executor=executor, device="cpu", **kw)


def _ref(backend="numpy", executor=None, **kw):
    pol = {k: kw.pop(k) for k in list(kw)
           if k in JaxFlushPolicy.__annotations__}
    return JaxDecompressionService(policy=JaxFlushPolicy(**pol),
                                   backend=TWINS[backend], executor=executor,
                                   **kw)


def _pair(backend="numpy", **kw):
    return _port(backend, **dict(kw)), _ref(backend, **dict(kw))


def _same(a, b):
    """Answer dicts equal bitwise."""
    assert set(a) == set(b)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


def _corrupt_copy(packed: bytes) -> bytes:
    """The first decision byte of a mid-stream chunk set to 0xFF (a bogus
    overwrite prefix: the walk overruns the indexed chunk length); the
    footer CRC covers only the index, so attaching still succeeds."""
    store = Container(packed)
    off = (int(store._cols["offset"][store.n_chunks - 2])
           + stream_mod._HDR.size)
    bad = bytearray(packed)
    bad[off] = 0xFF
    return bytes(bad)


class LazyFuture:
    """Runs its stage only when collected."""

    def __init__(self, fn, args, log, tag, executed_at):
        self._fn, self._args, self._log, self._tag = fn, args, log, tag
        self._executed_at = executed_at

    def result(self):
        self._log.append(("execute", self._tag))
        self._executed_at[self._tag] = time.perf_counter()
        return self._fn(*self._args)


class LazyExecutor:
    def __init__(self, log):
        self.log = log
        self.executed_at = {}   # submit number -> perf_counter() at execute
        self._n = 0

    def submit(self, fn, *args):
        self._n += 1
        self.log.append(("submit", self._n))
        return LazyFuture(fn, args, self.log, self._n, self.executed_at)

    def shutdown(self):
        self.log.append(("shutdown", None))


# ---------------------------------------------------------- service reads
@pytest.mark.parametrize("backend", BACKENDS)
def test_reads_and_batches_equal_reference(backend):
    packed, y = _prepped("std_D32")
    port, ref = _pair(backend, max_batch_streams=3)
    outs = []
    for svc in (port, ref):
        svc.attach("g", packed)
        with pytest.raises(KeyError):
            svc.attach("g", packed)
        got = {"read": svc.read("g", 2, 6)}
        assert svc.submit("r1", "g", 0, 4) is None
        assert svc.submit("r2", "g", 10, 12) is None
        with pytest.raises(KeyError):
            svc.submit("r1", "g", 0, 1)
        got.update(svc.submit("r3", "g", 39, 40))
        got["full"] = svc.read_channels("g")[0]
        with pytest.raises(IndexError):
            svc.submit("r4", "g", 0, 10 ** 6)
        outs.append(got)
    _same(*outs)
    assert port.stats == ref.stats and port.stats["flushes"] == 1
    assert outs[0]["r1"].tobytes() == y[:4 * B].tobytes()
    assert outs[0]["full"].tobytes() == y.tobytes()
    port.detach("g")
    with pytest.raises(KeyError):
        port.read("g", 0, 1)


def test_handle_decode_range_request():
    packed, y = _prepped("delta_D32")
    svc = _port("cuda")
    svc.attach("s", packed)
    res = svc.handle(api.DecodeRangeRequest(
        store_id="s", start_block=3, stop_block=9, request_id="q1"))
    assert isinstance(res, api.RangeResult) and res.request_id == "q1"
    assert res.values.tobytes() == y[3 * B:9 * B].tobytes()
    assert svc.stats["requests"] == 1 and svc.stats["blocks_out"] == 6


def test_detach_drops_pending_accounting():
    packed, y = _prepped("std_D32")
    t = [0.0]
    outs = []
    for svc in _pair(max_batch_blocks=50, max_age_s=10.0,
                     clock=lambda: t[0]):
        t[0] = 0.0
        svc.attach("a", packed)
        svc.attach("b", packed)
        assert svc.submit("r1", "a", 0, 40) is None
        svc.detach("a")
        t[0] = 9.0
        assert svc.submit("r2", "b", 0, 20) is None
        assert svc.poll() is None
        t[0] = 19.5
        out = svc.poll()
        assert set(out) == {"r2"}
        assert out["r2"].tobytes() == y[:20 * B].tobytes()
        assert type(svc.last_errors["r1"]) is KeyError
        outs.append(svc.stats)
    assert outs[0] == outs[1] and outs[0]["failed_requests"] == 1


def test_chunk_lru_hits_misses_and_budget():
    packed, _ = _prepped("std_D32", feed=4 * B)
    stats = []
    for svc in _pair(cache_blocks=10 ** 9):
        svc.attach("s", packed)
        svc.read("s", 17, 19)
        misses0 = svc.stats["cache_misses"]
        svc.read("s", 17, 19)
        assert svc.stats["cache_misses"] == misses0
        assert svc.stats["cache_hits"] >= 1
        stats.append(svc.stats)
    assert stats[0] == stats[1]
    budgets = []
    for svc in _pair(cache_blocks=4):
        svc.attach("s", packed)
        svc.read("s", 0, Container(packed).total_blocks(0))
        assert svc._cached_blocks <= 4
        budgets.append((svc._cached_blocks, svc.stats))
    assert budgets[0] == budgets[1]


def test_lru_shared_by_two_attaches_of_one_file(tmp_path):
    packed, _ = _prepped("std_D32", feed=4 * B)
    path = tmp_path / "c.idlmc"
    path.write_bytes(packed)
    from repro.store import Container as JaxContainer
    stats = []
    for svc, open_ in ((_port(), Container.open),
                       (_ref(), JaxContainer.open)):
        svc.attach("a", open_(str(path)))
        svc.attach("b", open_(str(path)))
        svc.read("a", 17, 19)
        misses0 = svc.stats["cache_misses"]
        svc.read("b", 17, 19)
        assert svc.stats["cache_misses"] == misses0
        svc.detach("a")  # shared-token entries survive while "b" lives
        svc.read("b", 17, 19)
        assert svc.stats["cache_misses"] == misses0
        svc.detach("b")
        assert svc._cached_blocks == 0
        stats.append(svc.stats)
    assert stats[0] == stats[1]


def test_deadline_injected_clock():
    packed, y = _prepped("std_D1")
    t = [0.0]
    for svc in _pair(max_age_s=0.5, clock=lambda: t[0]):
        t[0] = 0.0
        svc.attach("s", packed)
        assert svc.submit("a", "s", 1, 3) is None
        assert svc.poll() is None
        t[0] = 0.6
        out = svc.poll()
        assert out["a"].tobytes() == y[B:3 * B].tobytes()
        assert svc.poll() is None


@pytest.mark.parametrize("backend", BACKENDS)
def test_flush_isolates_failing_group(backend):
    packed, y = _prepped("std_D32")
    bad = _corrupt_copy(packed)
    nb = Container(packed).total_blocks(0)
    outs = []
    for svc in _pair(backend, max_batch_streams=2):
        svc.attach("good", packed)
        svc.attach("bad", bad)
        assert svc.submit("rb", "bad", 0, nb) is None
        ans = svc.submit("rg", "good", 3, 7)
        assert set(ans) == {"rg"}
        assert ans["rg"].tobytes() == y[3 * B:7 * B].tobytes()
        outs.append((type(svc.last_errors["rb"]).__name__, svc.stats))
    assert outs[0] == outs[1]
    assert isinstance(_port().last_errors, dict)
    assert outs[0][0] == StreamFormatError.__name__


@pytest.mark.parametrize("backend", BACKENDS)
def test_mixed_length_requests_and_dispatches(backend):
    """Short and long requests of one flush: the host backend splits by
    pow-2 length bucket, a device backend merges; answers exact and the
    dispatch counts the reference's."""
    packed, y = _prepped("std_D32")
    nb = Container(packed).total_blocks(0)
    reqs = [("a", 0, 1), ("b", 5, 6), ("c", 17, 18), ("d", 0, nb),
            ("e", 8, 10)]
    outs = []
    for svc in _pair(backend, max_batch_streams=5):
        svc.attach("s", packed)
        for rid, i, j in reqs[:-1]:
            assert svc.submit(rid, "s", i, j) is None
        ans = svc.submit(reqs[-1][0], "s", *reqs[-1][1:])
        for rid, i, j in reqs:
            assert ans[rid].tobytes() == y[i * B:j * B].tobytes()
        outs.append(svc.stats)
    assert outs[0] == outs[1]
    assert outs[0]["dispatches"] == (3 if backend == "numpy" else 1)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_device_flush_merges_two_stores(backend):
    """Requests against TWO attaches of one delta container merge into ONE
    device dispatch (one K2 call on ``cuda``) and answer exactly."""
    packed, y = _prepped("delta_D32")
    nb = Container(packed).total_blocks(0)
    reqs = [("r1", "a", 0, 4), ("r2", "b", 10, 12), ("r3", "a", 0, nb),
            ("r4", "b", nb - 1, nb)]
    calls = []
    real = k2.seq_cumsum
    k2.seq_cumsum = lambda x: calls.append(x.shape) or real(x)
    try:
        outs = []
        for svc in _pair(backend, max_batch_streams=4):
            svc.attach("a", packed)
            svc.attach("b", packed)
            for rid, sid, i, j in reqs[:-1]:
                assert svc.submit(rid, sid, i, j) is None
            ans = svc.submit(*reqs[-1])
            for rid, _, i, j in reqs:
                assert ans[rid].tobytes() == y[i * B:j * B].tobytes()
            assert svc.read("a", 2, 6).tobytes() == y[2 * B:6 * B].tobytes()
            outs.append(svc.stats)
    finally:
        k2.seq_cumsum = real
    assert outs[0] == outs[1] and outs[0]["dispatches"] == 1
    assert len(calls) == (2 if backend == "cuda" else 0)  # flush + read


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_device_flush_splits_pathological_padding(backend):
    packed, y = _prepped("std_D32")
    nb = Container(packed).total_blocks(0)
    n_tiny = 30
    reqs = [("big", 0, nb)] + [(f"t{k}", k, k + 1) for k in range(n_tiny)]
    outs = []
    for svc in _pair(backend, max_batch_streams=n_tiny + 1,
                     max_batch_blocks=nb + n_tiny):
        svc.attach("s", packed)
        for rid, i, j in reqs[:-1]:
            assert svc.submit(rid, "s", i, j) is None
        ans = svc.submit(reqs[-1][0], "s", *reqs[-1][1:])
        for rid, i, j in reqs:
            assert ans[rid].tobytes() == y[i * B:j * B].tobytes(), rid
        outs.append(svc.stats)
    assert outs[0] == outs[1] and outs[0]["dispatches"] >= 2


# ------------------------------------------------------------ the pipeline
def _stage_starts(since: float) -> dict:
    """``(stage, flush seq) -> start_s`` of the port's ``serve.<stage>``
    spans begun after ``since``, read from the span ring."""
    return {(r.name[len("serve."):], r.attrs["seq"]): r.start_s
            for r in obs.tracer().records(kind="span")
            if r.name.startswith("serve.") and r.start_s >= since}


def test_plan_of_next_batch_runs_while_reconstruct_in_flight():
    packed, y = _prepped("std_D32")
    ex = LazyExecutor([])
    since = time.perf_counter()
    svc = _port(max_batch_streams=2, pipeline_depth=2, executor=ex)
    svc.attach("s", packed)
    assert svc.submit("a", "s", 0, 2) is None
    r1 = svc.submit("b", "s", 2, 4)
    assert r1 == {} and svc.inflight == 1
    assert svc.submit("c", "s", 4, 6) is None
    r2 = svc.submit("d", "s", 6, 8)
    assert set(r2) == {"a", "b"}
    assert set(svc.drain()) == {"c", "d"}
    assert svc.inflight == 0
    at = _stage_starts(since)
    assert at[("plan", 2)] < ex.executed_at[1]
    assert at[("gather", 2)] < ex.executed_at[1]
    for seq in (1, 2):
        assert (at[("plan", seq)] < at[("gather", seq)]
                < at[("reconstruct", seq)] < at[("emit", seq)])
    assert svc.stats["inflight_peak"] == 2


def test_depth1_is_the_alternating_path():
    packed, y = _prepped("std_D32")
    since = time.perf_counter()
    svc = _port(max_batch_streams=2)
    svc.attach("s", packed)
    assert svc.submit("a", "s", 0, 2) is None
    out = svc.submit("b", "s", 2, 4)
    assert set(out) == {"a", "b"} and svc.inflight == 0
    at = _stage_starts(since)
    assert sorted(at, key=at.get) == [("plan", 1), ("gather", 1),
                                      ("reconstruct", 1), ("emit", 1)]
    assert svc.drain() == {}
    assert out["a"].tobytes() == y[:2 * B].tobytes()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_pipelined_flushes_byte_identical(name, backend):
    """Depth 1 and depth 2 (a real worker thread) answer every request
    byte for byte as the reference's numpy service and ``decode_stream``."""
    packed, y = _prepped(name)
    nb = Container(packed).total_blocks(0)
    reqs = [(i, min(i + 3, nb)) for i in range(0, nb, 3)] + [(0, nb)]

    def run(svc):
        svc.attach("s", packed)
        out = {}
        for k, (i, j) in enumerate(reqs):
            out.update(svc.submit(f"r{k}", "s", i, j) or {})
        out.update(svc.close())
        assert not svc.last_errors
        return out

    alt = run(_port(backend, max_batch_streams=3))
    pip = run(_port(backend, max_batch_streams=3, pipeline_depth=2))
    ref = run(_ref("numpy", max_batch_streams=3))
    _same(alt, pip)
    _same(alt, ref)
    for k, (i, j) in enumerate(reqs):
        assert alt[f"r{k}"].tobytes() == y[i * B:j * B].tobytes()


def test_plan_failure_quarantines_store_mid_pipeline():
    packed, y = _prepped("std_D32")
    nb = Container(packed).total_blocks(0)
    svc = _port(max_batch_streams=2, pipeline_depth=2,
                executor=LazyExecutor([]))
    svc.attach("good", packed)
    svc.attach("bad", _corrupt_copy(packed))
    assert svc.submit("g1", "good", 0, 2) is None
    assert svc.submit("g2", "good", 2, 4) == {}
    assert svc.submit("rb", "bad", 0, nb) is None
    r2 = svc.submit("rg", "good", 3, 7)
    assert isinstance(svc.last_errors["rb"], StreamFormatError)
    assert set(r2) == {"g1", "g2"}
    rest = svc.close()
    assert set(rest) == {"rg"}
    assert rest["rg"].tobytes() == y[3 * B:7 * B].tobytes()
    assert svc.stats["failed_requests"] == 1


def test_reconstruct_failure_quarantines_unit(monkeypatch):
    std_packed, y_std = _prepped("std_D32")
    delta_packed, _ = _prepped("delta_D32")
    real = decode_mod.reconstruct

    def boom(plan, backend="cuda", device=None):
        if plan.mode == decode_mod.MODE_DELTA:
            raise RuntimeError("device lost")
        return real(plan, backend=backend, device=device)

    monkeypatch.setattr(decode_mod, "reconstruct", boom)
    svc = _port(max_batch_streams=2, pipeline_depth=2,
                executor=LazyExecutor([]))
    svc.attach("std", std_packed)
    svc.attach("delta", delta_packed)
    assert svc.submit("rs", "std", 0, 4) is None
    assert svc.submit("rd", "delta", 0, 4) == {}
    out = svc.close()
    assert set(out) == {"rs"}
    assert out["rs"].tobytes() == y_std[:4 * B].tobytes()
    assert isinstance(svc.last_errors["rd"], RuntimeError)
    assert svc.stats["failed_requests"] == 1
    assert svc.stats["dispatches"] == 1


def test_dead_executor_fails_whole_batch():
    class ExplodingExecutor:
        def submit(self, fn, *args):
            fut = StageFuture()
            fut.set_exception(RuntimeError("executor died"))
            return fut

        def shutdown(self):
            pass

    packed, _ = _prepped("std_D32")
    svc = _port(max_batch_streams=2, executor=ExplodingExecutor())
    svc.attach("s", packed)
    svc.submit("a", "s", 0, 2)
    assert svc.submit("b", "s", 2, 4) == {}
    assert isinstance(svc.last_errors["a"], RuntimeError)
    assert isinstance(svc.last_errors["b"], RuntimeError)
    assert svc.stats["failed_requests"] == 2


def test_completed_batches_not_stranded_without_new_traffic():
    packed, y = _prepped("std_D32")
    svc = _port("cuda", max_batch_streams=2, pipeline_depth=2)
    svc.attach("s", packed)
    svc.submit("a", "s", 0, 2)
    assert svc.submit("b", "s", 2, 4) == {}
    deadline = time.monotonic() + 5.0
    out = None
    while out is None and time.monotonic() < deadline:
        out = svc.poll()
    assert out is not None and set(out) == {"a", "b"}
    assert out["a"].tobytes() == y[:2 * B].tobytes()
    assert svc.flush() == {} and svc.poll() is None
    svc.submit("c", "s", 4, 6)
    assert svc.submit("d", "s", 6, 8) == {}
    deadline = time.monotonic() + 5.0
    out = {}
    while not out and time.monotonic() < deadline:
        out = svc.flush()
    assert set(out) == {"c", "d"}
    svc.close()


def test_closed_service_rejects_new_work():
    packed, _ = _prepped("std_D32")
    svc = _port(max_batch_streams=2, pipeline_depth=2)
    svc.attach("s", packed)
    svc.submit("a", "s", 0, 2)
    assert set(svc.close()) == {"a"}
    assert svc.close() == {}
    with pytest.raises(RuntimeError):
        svc.submit("b", "s", 0, 2)
    with pytest.raises(RuntimeError):
        svc.flush()


def test_duplicate_id_rejected_while_batch_in_flight():
    packed, _ = _prepped("std_D32")
    svc = _port(max_batch_streams=2, pipeline_depth=2,
                executor=LazyExecutor([]))
    svc.attach("s", packed)
    svc.submit("a", "s", 0, 2)
    assert svc.submit("b", "s", 2, 4) == {}
    with pytest.raises(KeyError):
        svc.submit("a", "s", 4, 6)
    assert set(svc.drain()) == {"a", "b"}
    svc.submit("a", "s", 4, 6)


def test_cold_autotune_probe_quiesces_pipeline(monkeypatch):
    packed, y = _prepped("std_D32")
    decode_mod.reset_autotune()
    log = []
    real_probe = decode_mod._probe_autotune

    def spy_probe(*args, **kw):
        log.append(("probe",))
        return real_probe(*args, **kw)

    monkeypatch.setattr(decode_mod, "_probe_autotune", spy_probe)
    svc = _port("auto", max_batch_streams=2, pipeline_depth=2,
                executor=LazyExecutor(log))
    svc.attach("s", packed)
    svc.submit("a", "s", 0, 2)
    r1 = svc.submit("b", "s", 2, 4)
    assert ("probe",) in log and r1 == {}
    n_probes = log.count(("probe",))
    decode_mod.reset_autotune()
    svc.submit("c", "s", 4, 6)
    r2 = svc.submit("d", "s", 6, 8)
    i_exec1 = log.index(("execute", 1))
    i_probe2 = len(log) - 1 - log[::-1].index(("probe",))
    assert log.count(("probe",)) == n_probes + 1
    assert i_exec1 < i_probe2
    assert set(r2) == {"a", "b"}
    out = svc.close()
    assert set(out) == {"c", "d"}
    for rid, i, j in [("a", 0, 2), ("b", 2, 4)]:
        assert r2[rid].tobytes() == y[i * B:j * B].tobytes()
    for rid, i, j in [("c", 4, 6), ("d", 6, 8)]:
        assert out[rid].tobytes() == y[i * B:j * B].tobytes()
    decode_mod.reset_autotune()


def test_auto_resolves_at_merged_dispatch_size(monkeypatch):
    packed, _ = _prepped("std_D32")
    seen = []
    real = decode_mod.resolve_backend

    def spy(backend, mode, dtype, nb, value_range=None, block_size=32,
            device=None):
        if backend == "auto":
            seen.append(nb)
        return real("numpy", mode, dtype, nb, value_range, block_size)

    monkeypatch.setattr(decode_mod, "resolve_backend", spy)
    svc = _port("auto", max_batch_streams=4)
    svc.attach("s", packed)
    for k, (i, j) in enumerate([(0, 2), (4, 6), (8, 10)]):
        svc.submit(f"r{k}", "s", i, j)
    assert len(svc.submit("r3", "s", 12, 14)) == 4
    assert seen == [8]


def test_stage_pipeline_window_and_error_delivery():
    pipe = StagePipeline(LazyExecutor([]), depth=2)
    assert pipe.push("m1", lambda: 1) == []
    assert pipe.inflight == 1
    assert pipe.push("m2", lambda: 2) == [("m1", 1, None)]
    (meta, value, exc), = pipe.drain()
    assert (meta, value, exc) == ("m2", 2, None)

    def boom():
        raise ValueError("stage died")

    reg = obs.registry()
    n0 = reg.get_value("repro_serve_stage_errors_total")
    pipe.push("m3", boom)
    (meta, value, exc), = pipe.drain()
    assert meta == "m3" and value is None and isinstance(exc, ValueError)
    assert reg.get_value("repro_serve_stage_errors_total") == n0 + 1
    with pytest.raises(ValueError):
        StagePipeline(SyncExecutor(), depth=0)
    sync = StagePipeline(SyncExecutor(), depth=2)
    assert sync.push("m1", lambda: 1) == [("m1", 1, None)]
    assert sync.inflight == 0


def test_thread_executor_runs_off_thread_and_shuts_down():
    import threading
    ex = ThreadStageExecutor()
    try:
        assert ex.submit(threading.get_ident).result() != \
            threading.get_ident()
        with pytest.raises(RuntimeError):
            ex.submit(lambda: (_ for _ in ()).throw(
                RuntimeError("worker"))).result()
        assert ex.submit(lambda a, b: a + b, 2, 3).result() == 5
    finally:
        ex.shutdown()
    ex.shutdown()  # idempotent
    with pytest.raises(RuntimeError, match="shut down"):
        ex.submit(lambda: 1).result()


# ------------------------------------------------------- the decode autotune
@pytest.fixture
def autotune_file(tmp_path, monkeypatch):
    path = tmp_path / "decode_autotune.json"
    monkeypatch.setenv("REPRO_TORCH_DECODE_AUTOTUNE", str(path))
    monkeypatch.setenv("REPRO_DECODE_AUTOTUNE", str(tmp_path / "ref.json"))
    decode_mod.reset_autotune()
    decode_mod.reset_decode_stats()
    yield path
    decode_mod.reset_autotune()


def _resolve(mode, nb, dtype="f8"):
    return decode_mod.resolve_backend("auto", mode, dtype, nb, device="cpu")


def test_autotune_cold_probe_then_warm_hit(autotune_file):
    reg = obs.registry()
    b1 = _resolve(decode_mod.MODE_STD, 10)
    st = decode_mod.decode_stats()
    assert st["autotune_probes"] == 1 and st["autotune_hits"] == 0
    assert b1 in decode_mod.BACKENDS
    doc = json.loads(autotune_file.read_text())
    assert doc["version"] == decode_mod.AUTOTUNE_VERSION
    (key, ent), = doc["entries"].items()
    assert key.endswith("|device=cpu")
    assert set(ent["times_us"]) == {"numpy", "torch", "cuda"}
    assert not (autotune_file.parent / "ref.json").exists()
    b2 = _resolve(decode_mod.MODE_STD, 33)
    st = decode_mod.decode_stats()
    assert (b2, st["autotune_probes"], st["autotune_hits"]) == (b1, 1, 1)
    _resolve(decode_mod.MODE_STD, 900)
    assert decode_mod.decode_stats()["autotune_probes"] == 2
    assert decode_mod.decode_stats()["autotune_choices"] \
        == decode_mod.autotune_choices() and len(
            decode_mod.autotune_choices()) == 2
    assert reg.get_value("repro_decode_autotune_probes_total") == 2
    assert reg.get_value("repro_decode_autotune_hits_total") == 1
    assert reg.get_value("repro_tuning_probes_total",
                         {"tuner": "decode"}) == 2


def test_autotune_persisted_choice_honored_without_probing(autotune_file):
    key = decode_mod._autotune_key(decode_mod.MODE_STD, "f8", 10, "cpu")
    autotune_file.write_text(json.dumps({
        "version": decode_mod.AUTOTUNE_VERSION,
        "entries": {key: {"backend": "torch", "times_us": {}}}}))
    got = _resolve(decode_mod.MODE_STD, 10)
    st = decode_mod.decode_stats()
    assert (got, st["autotune_probes"], st["autotune_hits"]) \
        == ("torch", 0, 1)
    assert decode_mod.autotune_cached(decode_mod.MODE_STD, "f8", 40, "cpu")


@pytest.mark.parametrize("content", [
    json.dumps({"version": 99, "entries": {}}), "\xffnot json at all",
    json.dumps({"version": 1, "entries": {"k": {"backend": "jax",
                                                "times_us": {}}}})],
    ids=["version", "corrupt", "foreign-backend"])
def test_autotune_stale_or_corrupt_cache_reprobes(autotune_file, content):
    autotune_file.write_text(content)
    with pytest.raises(decode_mod.AutotuneCacheError):
        decode_mod.load_autotune(str(autotune_file), strict=True)
    decode_mod.reset_autotune()
    assert _resolve(decode_mod.MODE_DELTA, 10) in decode_mod.BACKENDS
    assert decode_mod.decode_stats()["autotune_probes"] == 1
    doc = json.loads(autotune_file.read_text())
    assert doc["version"] == decode_mod.AUTOTUNE_VERSION


def test_autotune_unwritable_cache_path_is_non_fatal(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_DECODE_AUTOTUNE",
                       str(tmp_path / "no" / "such" / "dir" / "at.json"))
    decode_mod.reset_autotune()
    decode_mod.reset_decode_stats()
    assert _resolve(decode_mod.MODE_STD, 10) in decode_mod.BACKENDS
    assert decode_mod.decode_stats()["autotune_probes"] == 1
    decode_mod.reset_autotune()


def test_reconstruct_auto_equals_host_path(autotune_file):
    for mode in (decode_mod.MODE_STD, decode_mod.MODE_RESIDUAL,
                 decode_mod.MODE_DELTA):
        plan = decode_mod._probe_plan(mode, "f8", (0.0, 360.0), 16)
        want = decode_mod.reconstruct(plan, backend="numpy")
        got = decode_mod.reconstruct(plan, backend="auto", device="cpu")
        assert got.tobytes() == want.tobytes()
    assert decode_mod.decode_stats()["autotune_probes"] == 3


@pytest.mark.parametrize("bad", ["torch", "cuda"])
def test_inexact_device_backend_raises(autotune_file, monkeypatch, bad):
    """No fallback: a device backend whose probe bytes differ from the host
    path makes ``"auto"`` raise, naming the backend; nothing is recorded."""
    real = decode_mod._run_device

    def off_by_one_ulp(plan, backend, device):
        out = real(plan, backend, device)
        if backend == bad:
            out = np.nextafter(out, np.inf)
        return out

    monkeypatch.setattr(decode_mod, "_run_device", off_by_one_ulp)
    with pytest.raises(RuntimeError, match=f"'{bad}' is not byte-exact"):
        _resolve(decode_mod.MODE_DELTA, 10)
    assert decode_mod.autotune_choices() == {}
    assert not autotune_file.exists()


def test_failing_probe_raises(autotune_file, monkeypatch):
    def lost(plan, backend, device):
        raise RuntimeError("device lost")

    monkeypatch.setattr(decode_mod, "_run_device", lost)
    with pytest.raises(RuntimeError, match="device lost"):
        _resolve(decode_mod.MODE_STD, 10)


def test_auto_and_default_backend_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    plan = decode_mod._probe_plan(decode_mod.MODE_STD, "f8", None, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_mod.reconstruct(plan, backend="auto")
    with pytest.raises(RuntimeError, match="CUDA"):
        DecompressionService()
    assert DecompressionService(backend="numpy").backend == "numpy"
    assert _port("cuda").backend == "cuda"
    with pytest.raises(ValueError):
        DecompressionService(backend="gpu", device="cpu")
    with pytest.raises(ValueError):
        decode_mod.reconstruct(plan, backend="jax")


# --------------------------------------------------------------- telemetry
def _families(reg, prefix):
    snap = reg.snapshot()
    return {name: (fam["kind"], fam["help"], sorted(tuple(sorted(v["labels"].items()))
                                       for v in fam["values"]))
            for name, fam in snap.items() if name.startswith(prefix)}


def _pipelined_auto_flush(make_coal, make_svc, pack_fn):
    rng = np.random.default_rng(1)
    coal = make_coal()
    coal.open_stream("s")
    blob = b""
    for _ in range(4):
        out = coal.submit("s", rng.normal(0, 1, size=256)) or {}
        blob += out.get("s", b"")
    blob += coal.close_stream("s")
    svc = make_svc()
    svc.attach("s", pack_fn(blob))
    answers = {}
    for i, (lo, hi) in enumerate([(0, 8), (4, 12)]):
        svc.submit(f"r{i}", "s", lo, hi)
    answers.update(svc.flush())
    for i, (lo, hi) in enumerate([(2, 10), (0, 16)], start=2):
        svc.submit(f"r{i}", "s", lo, hi)
    answers.update(svc.flush())
    answers.update(svc.close())
    return answers, svc


# the port's own families, which the reference lacks: a coalescer
# flush's steps and its padded cells
PORT_ONLY = {"repro_encode_flush_step_seconds",
             "repro_encode_flush_cells_total"}


def test_serve_families_and_spans_equal_reference():
    """One pipelined ``backend="auto"`` service run: the ``repro_serve_*``
    and ``repro_encode_flush*`` families (names, types, label sets) equal
    the reference's after the same run, besides the port's own, and both
    record the four ``serve.<stage>`` spans of each flush (counted by an
    exporter as they finish: the ring may evict older records meanwhile)."""
    from repro.store import Container as JaxContainer
    decode_mod.reset_autotune()
    pol = dict(max_batch_blocks=256, max_batch_streams=2)
    kw = dict(mode="std", block_size=16, num_dict=8)
    stages = [f"serve.{st}" for st in ("plan", "gather", "reconstruct",
                                       "emit")]

    tracers = (obs.tracer(), jax_obs.tracer())
    finished = ([], [])   # record names, appended from any thread
    hooks = [lambda rec, names=names: names.append(rec.name)
             for names in finished]
    for t, hook in zip(tracers, hooks):
        t.add_exporter(hook)
    try:
        got, port = _pipelined_auto_flush(
            lambda: StreamCoalescer(policy=FlushPolicy(**pol), device="cpu",
                                    **kw),
            lambda: _port("auto", max_batch_streams=8, pipeline_depth=2),
            lambda blob: Container(pack(blob)))
        want, ref = _pipelined_auto_flush(
            lambda: JaxStreamCoalescer(policy=JaxFlushPolicy(**pol),
                                       backend="jax", **kw),
            lambda: JaxDecompressionService(
                policy=JaxFlushPolicy(max_batch_streams=8,
                                      pipeline_depth=2),
                backend="numpy"),
            lambda blob: JaxContainer(jax_pack(blob)))
    finally:
        for t, hook in zip(tracers, hooks):
            t.remove_exporter(hook)
    _same(got, want)
    assert port.stats == ref.stats
    assert port.stats["cache_hits"] >= 1
    for prefix in ("repro_serve_", "repro_encode_flush",
                   "repro_encode_streams_open"):
        got = _families(obs.registry(), prefix)
        assert {k: v for k, v in got.items() if k not in PORT_ONLY} == \
            _families(jax_obs.registry(), prefix), prefix
    assert PORT_ONLY <= set(_families(obs.registry(), "repro_encode_flush"))
    grew = [[names.count(n) for n in stages] for names in finished]
    assert grew[0] == grew[1] == [2, 2, 2, 2]
    text = obs.to_prometheus()
    assert obs.parse_prometheus(text)
    assert 'repro_serve_stage_seconds_count{stage="reconstruct"}' in text
    decode_mod.reset_autotune()
