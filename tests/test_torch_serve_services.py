"""The port's ingest services vs the JAX reference, on the CPU.

``FlushPolicy``, ``CompressionService``, ``StreamCoalescer`` (static and
adaptive), ``MixedCohort.decide(nb_pad=)``, ``data.pipeline`` and the
serve-layer telemetry of ``repro_torch`` are held against the reference
package's: the same numpy-seeded ragged traffic gives the same segment
bytes, stats dicts and flush counts.  The port's tensor backends run on
``device="cpu"``, where K1's wrapper runs its plain version.  Tolerance:
none (bytes equal).  Also here: the kernel build's lock and the launch
counters under two threads.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import GOLDEN_CASES, golden_codec_kwargs, golden_signal  # noqa: E402
from repro import api as jax_api  # noqa: E402
from repro import obs as jax_obs  # noqa: E402
from repro.core import IdealemCodec as JaxCodec  # noqa: E402
from repro.core.select import SelectorConfig as JaxSelectorConfig  # noqa: E402
from repro.core.session import MixedCohort as JaxMixedCohort  # noqa: E402
from repro.data.pipeline import compress_channels as jax_compress_channels  # noqa: E402
from repro.serve import CompressionService as JaxCompressionService  # noqa: E402
from repro.serve import FlushPolicy as JaxFlushPolicy  # noqa: E402
from repro.serve import StreamCoalescer as JaxStreamCoalescer  # noqa: E402
from repro_torch import api, obs  # noqa: E402
from repro_torch.core import IdealemCodec  # noqa: E402
from repro_torch.core.select import SelectorConfig  # noqa: E402
from repro_torch.core.session import MixedCohort  # noqa: E402
from repro_torch.core.stream import decode_stream  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.pipeline import (compress_channels,  # noqa: E402
                                       compressed_telemetry_reader)
from repro_torch.errors import ApiError  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import dict_match as k3  # noqa: E402
from repro_torch.kernels import encode_step as k1  # noqa: E402
from repro_torch.kernels import flash_decode as k4  # noqa: E402
from repro_torch.kernels import seq_cumsum as k2  # noqa: E402
from repro_torch.serve import (CompressionService, FlushPolicy,  # noqa: E402
                               StreamCoalescer)

B = 16
# port backend -> the reference backend it mirrors
TWINS = {"numpy": "numpy", "torch": "jax", "cuda": "jax"}
SEL = dict(warmup_blocks=4, patience=2, min_dwell_blocks=16)


def _port_kw(backend, **kw):
    return dict(kw, backend=backend, device="cpu")


def _ragged(n_streams, seed, base=B * 40):
    """Per-stream signals of ragged lengths (not multiples of B)."""
    rng = np.random.default_rng(seed)
    return {f"s{i}": rng.normal(i % 3, 1.0, size=base + 3 * i + 5)
            for i in range(n_streams)}


def _drive(co, signals, steps, close=True):
    """Round-robin ragged submits; returns (segments by stream, the feeds
    each stream's flushes cut, flushes).  ``feeds[sid]`` is the list of
    sample runs a flush took from the stream: a per-stream session fed the
    same runs emits the same segments."""
    segs = {sid: [] for sid in signals}
    feeds = {sid: [] for sid in signals}
    staged = {sid: [] for sid in signals}
    offs = dict.fromkeys(signals, 0)
    flushes = 0

    def cut(res):
        nonlocal flushes
        flushes += 1
        for sid in signals:
            if staged[sid]:
                feeds[sid].append(np.concatenate(staged[sid]))
                staged[sid] = []
        for k, v in res.items():
            segs[k].append(v)

    while any(offs[s] < len(x) for s, x in signals.items()):
        for sid, x in signals.items():
            if offs[sid] < len(x):
                chunk = x[offs[sid]:offs[sid] + steps[sid]]
                offs[sid] += steps[sid]
                staged[sid].append(chunk)
                res = co.submit(sid, chunk)
                if res is not None:
                    cut(res)
    if close:
        for sid in signals:
            if staged[sid]:
                feeds[sid].append(np.concatenate(staged[sid]))
            segs[sid].append(co.close_stream(sid))
    return {s: b"".join(v) for s, v in segs.items()}, feeds, flushes


def _steps(signals):
    return {sid: 29 + 17 * i for i, sid in enumerate(signals)}


# ------------------------------------------------------------ FlushPolicy
def test_flush_policy_decides_as_the_reference():
    """The pure policy: every (streams, blocks, age) of a grid trips
    exactly when the reference's does."""
    for kw in (dict(max_batch_blocks=100, max_batch_streams=10,
                    max_age_s=2.0),
               dict(max_age_s=0.1), dict()):
        p, q = FlushPolicy(**kw), JaxFlushPolicy(**kw)
        for n_streams in (0, 1, 9, 10, 300):
            for n_blocks in (0, 5, 99, 100, 5000):
                for age in (None, 0.05, 1.9, 2.0, 50.0):
                    assert p.should_flush(n_streams, n_blocks, age) == \
                        q.should_flush(n_streams, n_blocks, age), \
                        (kw, n_streams, n_blocks, age)
    p = FlushPolicy(max_batch_blocks=100, max_batch_streams=10,
                    max_age_s=2.0)
    assert not p.should_flush(1, 5, age_s=1.9)
    assert p.should_flush(1, 5, age_s=2.0)
    assert not p.should_flush(0, 0, age_s=50.0)
    assert not FlushPolicy(max_age_s=0.1).should_flush(1, 1)
    with pytest.raises(ValueError):
        FlushPolicy(pipeline_depth=0)


def test_flush_policy_with_updates_and_as_dict():
    p = FlushPolicy(max_batch_blocks=100, max_age_s=0.5)
    q = p.with_updates(max_batch_blocks=50)
    assert (q.max_batch_blocks, q.max_age_s) == (50, 0.5)
    assert p.max_batch_blocks == 100
    assert q.as_dict() == JaxFlushPolicy(
        max_batch_blocks=100, max_age_s=0.5).with_updates(
        max_batch_blocks=50).as_dict()
    assert hash(p) == hash(FlushPolicy(max_batch_blocks=100, max_age_s=0.5))


# ------------------------------------------------------ CompressionService
@pytest.mark.parametrize("container", [False, True])
@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda"])
def test_compression_service_bytes_equal_reference(backend, container):
    """Open, feed ragged chunks, close: segments (or the container) and the
    stats dicts equal the reference service's on its twin backend."""
    kw = dict(mode="delta", block_size=B, num_dict=8, alpha=0.05,
              rel_tol=0.5)
    sig = _ragged(2, seed=4)
    port = CompressionService(**_port_kw(backend, **kw))
    ref = JaxCompressionService(backend=TWINS[backend], **kw)
    outs = []
    for svc in (port, ref):
        got = {}
        for sid in sig:
            svc.open_stream(sid, container=container)
        for sid, x in sig.items():
            got[sid] = [svc.feed(sid, x[lo:lo + 70])
                        for lo in range(0, len(x), 70)]
            got[sid].append(svc.close_stream(sid))
        outs.append(got)
    assert outs[0] == outs[1]
    for sid in sig:
        assert port.stats(sid) == ref.stats(sid)
    assert port.stats() == ref.stats()
    assert port.active_streams == ref.active_streams == []


def test_compression_service_lifecycle_and_handle():
    kw = dict(mode="std", block_size=B, num_dict=8, alpha=0.05, rel_tol=0.5)
    port = CompressionService(**_port_kw("cuda", **kw))
    ref = JaxCompressionService(backend="jax", **kw)
    x = golden_signal("std_D32")
    for svc in (port, ref):
        svc.open_stream("a")
        with pytest.raises(KeyError):
            svc.open_stream("a")
        with pytest.raises(KeyError):
            svc.feed("nope", x)
    res = [port.handle(api.CompressRequest("a", x[:300])),
           ref.handle(jax_api.CompressRequest("a", x[:300]))]
    assert res[0].to_json() == res[1].to_json()
    assert res[0].blocks == 300 // B and res[0].segment
    # a closed id reopened keeps its old traffic in the aggregate
    for svc in (port, ref):
        svc.close_stream("a")
        svc.open_stream("a")
        svc.feed("a", x[:100])
    assert port.stats() == ref.stats()
    assert port.stats()["blocks"] == 300 // B + 100 // B
    # batched sessions: feed takes (C, m); handle refuses them
    port.open_stream("multi", channels=3)
    ref.open_stream("multi", channels=3)
    xs = np.stack([x, x[::-1], x + 1.0])
    assert port.feed("multi", xs[:, :200]) == ref.feed("multi", xs[:, :200])
    assert port.stats("multi") == ref.stats("multi")
    with pytest.raises(ApiError):
        port.handle(api.CompressRequest("multi", x[:32]))
    assert port.close_stream("multi") == ref.close_stream("multi")


# --------------------------------------------------------- StreamCoalescer
@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("mode,eb", [("std", None), ("residual", None),
                                     ("delta", None), ("std", 0.8)])
def test_coalescer_equals_reference_bytes(mode, eb, backend):
    """Five ragged streams through a coalescer that starts at 2 slots
    (grows 2 -> 4 -> 8, the error bound's raw rows included): segment bytes,
    flush counts, capacity and stats equal the reference's ``jax``
    coalescer fed the same submits."""
    kw = dict(mode=mode, block_size=B, num_dict=7, alpha=0.05, rel_tol=0.5,
              error_bound=eb)
    sig = _ragged(5, seed=3)
    pol = dict(max_batch_blocks=40)
    port = StreamCoalescer(policy=FlushPolicy(**pol), capacity=2,
                           **_port_kw(backend, **kw))
    ref = JaxStreamCoalescer(policy=JaxFlushPolicy(**pol), capacity=2,
                             backend="jax", **kw)
    for co in (port, ref):
        for sid in sig:
            co.open_stream(sid)
    got, _, n_port = _drive(port, sig, _steps(sig))
    want, _, n_ref = _drive(ref, sig, _steps(sig))
    assert got == want
    assert n_port == n_ref > 2
    assert port.capacity == ref.capacity == 8
    assert port.stats() == ref.stats()
    for sid in sig:
        assert port.stats(sid) == ref.stats(sid)


def test_coalescer_equals_per_stream_service():
    """Each stream's bytes equal a per-stream ``CompressionService`` fed the
    runs the coalescer's flushes cut, and decode to the one-shot encode."""
    kw = _port_kw("cuda", mode="residual", block_size=B, num_dict=31,
                  alpha=0.05, rel_tol=0.5)
    sig = _ragged(5, seed=5, base=B * 50)
    co = StreamCoalescer(policy=FlushPolicy(max_batch_blocks=40), capacity=2,
                         **kw)
    for sid in sig:
        co.open_stream(sid)
    got, feeds, _ = _drive(co, sig, _steps(sig))
    svc = CompressionService(**kw)
    codec = IdealemCodec(**kw)
    for sid, x in sig.items():
        svc.open_stream(sid)
        want = b"".join([svc.feed(sid, f) for f in feeds[sid]]
                        + [svc.close_stream(sid)])
        assert got[sid] == want
        np.testing.assert_array_equal(
            decode_stream(got[sid], backend="numpy"),
            codec.decode(codec.encode(x), backend="numpy"))
    assert co.stats()["blocks"] == sum(len(x) // B for x in sig.values())


@pytest.mark.parametrize("eb", [None, 0.8])
def test_coalescer_slot_reuse_is_fresh_and_in_place(eb):
    """A recycled slot decides like a fresh dictionary; the reset clears
    the slot's rows and counter in place on the carry the scan returned."""
    kw = _port_kw("cuda", mode="std", block_size=B, num_dict=7, alpha=0.05,
                  rel_tol=0.5, error_bound=eb)
    codec = IdealemCodec(**kw)
    x = np.random.default_rng(9).normal(size=B * 40)
    co = StreamCoalescer(capacity=1, **kw)
    for name in ("a", "b"):
        co.open_stream(name)
        co.submit(name, x)
        blob = co.close_stream(name)
        np.testing.assert_array_equal(
            decode_stream(blob, backend="numpy"),
            codec.decode(codec.encode(x), backend="numpy"))
        state = co._state
        assert bool(state.valid[0].any()) and int(state.count[0]) > 0
    co.open_stream("c")  # recycles slot 0 again
    assert co._state is state
    assert not bool(state.valid[0].any()) and int(state.count[0]) == 0
    with pytest.raises(KeyError):
        co.submit("a", x)
    with pytest.raises(KeyError):
        co.open_stream("c")


def test_coalescer_grow_keeps_every_field():
    kw = _port_kw("cuda", mode="std", block_size=B, num_dict=5, alpha=0.05,
                  rel_tol=0.5)
    co = StreamCoalescer(capacity=1, **kw)
    co.open_stream("a")
    co.submit("a", np.arange(3 * B, dtype=np.float64))
    co.flush()
    before = [f.clone() for f in co._state]
    co.open_stream("b")  # no free slot: 1 -> 2
    assert co.capacity == 2
    for old, new in zip(before, co._state):
        assert new.shape == (2,) + old.shape[1:] and new.dtype == old.dtype
        assert torch.equal(new[:1], old) and not new[1:].any()
    assert co._state.raw_blocks.shape[1] == 0  # the empty raw rows grew too


def test_coalescer_deadline_injected_clock():
    """Age-triggered flushes on an injected clock, against the reference
    coalescer driven through the same timeline."""
    t = [0.0]
    pol = dict(max_age_s=2.0, max_batch_blocks=10 ** 9,
               max_batch_streams=10 ** 9)
    kw = dict(mode="std", block_size=B, num_dict=8, alpha=0.05, rel_tol=0.5)
    port = StreamCoalescer(policy=FlushPolicy(**pol), clock=lambda: t[0],
                           **_port_kw("cuda", **kw))
    ref = JaxStreamCoalescer(policy=JaxFlushPolicy(**pol),
                             clock=lambda: t[0], backend="jax", **kw)
    rng = np.random.default_rng(0)
    a, b, b2, b3, c = (rng.normal(size=n) for n in (100, 50, 3, 40, 40))
    timeline = []
    for co in (port, ref):
        t[0] = 0.0
        log = []
        co.open_stream("a")
        co.open_stream("b")
        log.append(co.submit("a", a))
        t[0] = 1.0
        log.append(co.submit("b", b))
        log.append(co.poll())
        assert co.pending_blocks == 100 // B + 50 // B
        assert co.staged_samples("b") == 50
        t[0] = 2.5
        log.append(co.poll())               # deadline expired
        log.append(co.close_stream("a"))
        log.append(co.poll())               # rearmed: nothing staged
        log.append(co.submit("b", b2))      # sub-block staging alone
        t[0] = 10.0
        log.append(co.poll())
        co.open_stream("c")
        t[0] = 20.0
        log.append(co.submit("b", b3))
        t[0] = 21.5
        log.append(co.submit("c", c))
        log.append(co.close_stream("b"))    # partial flush
        t[0] = 22.5
        log.append(co.poll())               # c is 1.0 old: holds
        t[0] = 23.6
        log.append(co.poll())               # c's own age trips
        log.append(co.close_stream("c"))
        timeline.append(log)
    assert timeline[0] == timeline[1]
    got = timeline[0]
    assert got[0] is None and got[1] is None and got[2] is None
    assert set(got[3]) == {"a", "b"}
    assert got[5] is None and got[7] is None and got[11] is None
    assert set(got[12]) == {"c"}
    with pytest.raises(KeyError):
        port.staged_samples("a")


def test_coalescer_rejects_numpy_backend_and_plans():
    kw = dict(mode="std", block_size=B, num_dict=8, device="cpu")
    with pytest.raises(ValueError, match="numpy backend"):
        StreamCoalescer(backend="numpy", **kw)
    # encode plans are ported: the port raises where the reference does,
    # on a plan whose channels are not a padded count and on a
    # dictionary-sharded plan for an adaptive coalescer
    from repro_torch.launch.encode_plan import make_encode_plan
    with pytest.raises(ValueError, match="padded channel count"):
        StreamCoalescer(plan=make_encode_plan(3, devices=["cpu"] * 2), **kw)
    with pytest.raises(ValueError, match="dict_shards=1"):
        StreamCoalescer(plan=make_encode_plan(2, devices=["cpu"] * 2,
                                              dict_shards=2),
                        adaptive=True, **kw)
    co = StreamCoalescer(**kw)
    co.open_stream("a")
    with pytest.raises(ValueError, match="1-D"):
        co.submit("a", np.zeros((2, 3)))
    with pytest.raises(KeyError):
        co.close_stream("zz")


def test_coalescer_cuda_flush_is_one_fused_scan(monkeypatch):
    """``backend="cuda"``: each flush that holds blocks is one call of K1's
    wrapper (``encode_scan``) over ``(capacity, nb_pad, n)`` with the
    ragged valid mask; a codec ``matcher`` overrides the fused default."""
    calls = []
    real = k1.encode_scan

    def spy(xs, valid, state, **kw):
        calls.append((tuple(xs.shape), valid.sum(dim=1).tolist()))
        return real(xs, valid, state, **kw)

    monkeypatch.setattr(k1, "encode_scan", spy)
    kw = _port_kw("cuda", mode="std", block_size=B, num_dict=8, alpha=0.05,
                  rel_tol=0.5)
    co = StreamCoalescer(policy=FlushPolicy(max_batch_streams=3),
                         block_bucket=4, capacity=4, **kw)
    for sid in "abc":
        co.open_stream(sid)
    co.submit("a", np.zeros(5 * B + 3))
    co.submit("b", np.ones(2 * B))
    res = co.submit("c", np.full(B - 1, 2.0))   # no block: not ready
    assert res is None and not calls
    res = co.submit("c", np.full(B, 2.0))        # third ready stream
    assert set(res) == {"a", "b", "c"} and len(calls) == 1
    assert calls[0] == ((4, 8, B), [5, 2, 1, 0])
    assert co.flush() == {} and len(calls) == 1
    ops = StreamCoalescer(matcher="reference", **kw)
    ops.open_stream("a")
    ops.submit("a", np.zeros(3 * B))
    ops.flush()
    assert len(calls) == 1


# ------------------------------------------------- the adaptive coalescer
def _adaptive_signals(C, n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    base = [rng.normal(0.0, 1.0, n),
            0.03 * t + rng.normal(0, 0.02, n),
            np.sin(t * 0.02) * 4 + rng.normal(0, 0.01, n)]
    return np.stack([base[ci % 3] for ci in range(C)])


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_adaptive_coalescer_matches_sessions_and_reference(backend):
    """Three adaptive streams (noise, trend, smooth: two switch) flushed
    each round: one mixed dispatch a flush; bytes equal per-stream adaptive
    sessions fed the same runs and the reference's ``jax`` coalescer; the
    bound holds."""
    kw = dict(mode="std", block_size=B, num_dict=8, adaptive=True,
              error_bound=0.6)
    data = _adaptive_signals(3, B * 40, seed=10)
    sids = [f"s{ci}" for ci in range(3)]
    pol = dict(max_batch_blocks=10 ** 9)
    port = StreamCoalescer(policy=FlushPolicy(**pol), capacity=4,
                           selector=SelectorConfig(**SEL),
                           **_port_kw(backend, **kw))
    ref = JaxStreamCoalescer(policy=JaxFlushPolicy(**pol), capacity=4,
                             selector=JaxSelectorConfig(**SEL),
                             backend="jax", **kw)
    outs = []
    feeds = [(lo, min(lo + 96, data.shape[1]))
             for lo in range(0, data.shape[1], 96)]
    for co in (port, ref):
        out = {sid: [] for sid in sids}
        for sid in sids:
            co.open_stream(sid)
        for lo, hi in feeds:
            for ci, sid in enumerate(sids):
                assert co.submit(sid, data[ci, lo:hi]) is None
            res = co.flush()
            for sid in sids:
                out[sid].append(res.get(sid, b""))
        dispatches = co._mixed.dispatches
        for sid in sids:
            out[sid].append(co.close_stream(sid))
        outs.append(({s: b"".join(v) for s, v in out.items()}, dispatches))
    assert outs[0] == outs[1]
    assert outs[0][1] == len(feeds)
    assert sum(port.stats(s)["mode_switches"] for s in sids) >= 1
    codec = IdealemCodec(selector=SelectorConfig(**SEL),
                         **_port_kw(backend, **kw))
    for ci, sid in enumerate(sids):
        s = codec.session()
        want = b"".join([s.feed(data[ci, lo:hi]) for lo, hi in feeds]
                        + [s.finish()])
        assert want == outs[0][0][sid]
        y = decode_stream(want, backend="numpy")
        assert np.max(np.abs(y - data[ci])) <= 0.6 + 1e-9


def test_adaptive_coalescer_slot_reuse_is_fresh():
    kw = _port_kw("cuda", mode="std", block_size=B, num_dict=4,
                  adaptive=True, selector=SelectorConfig(**SEL))
    co = StreamCoalescer(policy=FlushPolicy(max_batch_blocks=10 ** 9),
                         capacity=1, **kw)
    x = _adaptive_signals(3, B * 12, seed=11)[1]
    co.open_stream("a")
    co.submit("a", x)
    first = co.flush()["a"] + co.close_stream("a")
    co.open_stream("b")  # recycles slot 0: must look fresh
    co.submit("b", x)
    second = co.flush()["b"] + co.close_stream("b")
    assert first == second


def test_adaptive_coalescer_rejects_ops_matcher():
    with pytest.raises(ValueError, match="masked variant"):
        StreamCoalescer(mode="std", block_size=B, num_dict=8,
                        backend="cuda", adaptive=True, matcher="ops",
                        device="cpu")


def test_adaptive_coalescer_flush_is_one_chan_launch(monkeypatch):
    """A ``cuda`` adaptive flush is one call of K1's wrapper with its
    ``chan`` operand, padded to the bucketed block count."""
    calls = []
    real = k1.encode_scan

    def spy(xs, valid, state, **kw):
        calls.append((tuple(xs.shape), kw.get("chan") is not None))
        return real(xs, valid, state, **kw)

    monkeypatch.setattr(k1, "encode_scan", spy)
    co = StreamCoalescer(block_bucket=8, capacity=2,
                         **_port_kw("cuda", mode="std", block_size=B,
                                    num_dict=4, adaptive=True))
    co.open_stream("a")
    co.open_stream("b")
    co.submit("a", np.arange(3 * B, dtype=np.float64))
    co.submit("b", np.arange(5 * B, dtype=np.float64))
    co.flush()
    assert calls == [((2, 8, B), True)]


@pytest.mark.parametrize("nb_pad", [None, 4, 11])
def test_mixed_cohort_nb_pad_equals_reference(nb_pad):
    """``decide(entries, nb_pad=)``: the padded blocks neither insert nor
    count; decisions and carry equal the reference's (``jax`` arm) and the
    unpadded call's."""
    rng = np.random.default_rng(2)
    entries = [(0, rng.normal(size=(5, B)).astype(np.float32), 0.5, False,
                False),
               (2, rng.normal(size=(3, B - 1)).astype(np.float32), 0.4, True,
                False)]
    port = MixedCohort(4, 3, rel_tol=0.5, matcher="reference", device="cpu")
    plain = MixedCohort(4, 3, rel_tol=0.5, matcher="reference", device="cpu")
    ref = JaxMixedCohort(4, 3, rel_tol=0.5, matcher="reference")
    for _ in range(2):
        got = port.decide(entries, nb_pad=nb_pad)
        want = ref.decide(entries, nb_pad=nb_pad)
        base = plain.decide(entries)
        for lane in (0, 2):
            for g, w, b in zip(got[lane], want[lane], base[lane]):
                np.testing.assert_array_equal(g, np.asarray(w))
                np.testing.assert_array_equal(g, b)
    for f, g in zip(port.state, plain.state):
        assert torch.equal(f, g)
    for f, g in zip(port.state, ref.state):
        np.testing.assert_array_equal(f.numpy(), np.asarray(g))


# ------------------------------------------------------------ data pipeline
def test_compress_channels_equals_reference():
    chans = np.stack([synthetic.pmu_magnitude(B * 2 * 200, seed=s)
                      for s in range(4)])
    kw = dict(mode="std", block_size=32, num_dict=255, alpha=0.01,
              rel_tol=0.5)
    codec = IdealemCodec(**_port_kw("numpy", **kw))
    blobs, ratio = compress_channels(chans, codec)
    want, want_ratio = jax_compress_channels(chans,
                                             JaxCodec(backend="numpy", **kw))
    assert blobs == want and ratio == want_ratio and ratio > 10
    for x, y in zip(chans, compressed_telemetry_reader(blobs, codec)):
        assert y.shape == x.shape


# --------------------------------------------------------------- telemetry
def _get(reg, name, labels=None):
    return reg.get_value(name, labels)


def test_coalescer_flush_metrics_and_span():
    """A coalesced flush moves the encode flush metrics and records an
    ``encode.flush`` span, in step with the reference's (spans counted by
    an exporter as they finish: the ring may evict older records
    meanwhile)."""
    names = ("repro_encode_flushes_total", "repro_encode_bytes_in_total",
             "repro_encode_bytes_out_total", "repro_encode_blocks_total")
    deltas = []
    for reg, tracer, make in (
            (obs.registry(), obs.tracer(), lambda: StreamCoalescer(
                policy=FlushPolicy(max_batch_blocks=64, max_batch_streams=4),
                **_port_kw("cuda", mode="std", block_size=B, num_dict=8))),
            (jax_obs.registry(), jax_obs.tracer(), lambda: JaxStreamCoalescer(
                policy=JaxFlushPolicy(max_batch_blocks=64,
                                      max_batch_streams=4),
                mode="std", block_size=B, num_dict=8, backend="jax"))):
        before = {k: _get(reg, k) for k in names}
        finished = []
        hook = lambda rec: finished.append(rec.name)  # noqa: E731
        tracer.add_exporter(hook)
        open0 = _get(reg, "repro_encode_streams_open", {"kind": "coalesced"})
        rng = np.random.default_rng(0)
        co = make()
        blobs = {}
        for sid in ("a", "b"):
            co.open_stream(sid)
            blobs[sid] = b""
        assert _get(reg, "repro_encode_streams_open",
                    {"kind": "coalesced"}) == open0 + 2
        for _ in range(3):
            for sid in blobs:
                out = co.submit(sid, rng.normal(0, 1, size=64)) or {}
                for k, seg in out.items():
                    blobs[k] += seg
        for sid in list(blobs):
            blobs[sid] += co.close_stream(sid)
        tracer.remove_exporter(hook)
        assert all(blobs.values())
        deltas.append({k: _get(reg, k) - before[k] for k in names}
                      | {"spans": finished.count("encode.flush"),
                         "open": _get(reg, "repro_encode_streams_open",
                                      {"kind": "coalesced"}) - open0})
    assert deltas[0] == deltas[1]
    assert deltas[0]["repro_encode_flushes_total"] > 0


def test_session_streams_open_gauge():
    reg = obs.registry()
    g = ("repro_encode_streams_open", {"kind": "session"})
    n0 = _get(reg, *g)
    svc = CompressionService(**_port_kw("numpy", block_size=B, num_dict=4))
    svc.open_stream("a")
    assert _get(reg, *g) == n0 + 1
    svc.close_stream("a")
    assert _get(reg, *g) == n0


# ----------------------------------------------------------------- locking
def test_build_load_builds_and_opens_once_under_two_threads(monkeypatch):
    """Two threads racing a library's first use: one build, one dlopen,
    both get the same handle."""
    counts = {"build": 0, "open": 0}
    state = {"stale": True}
    barrier = threading.Barrier(2)

    def fake_build_all(force=False):
        counts["build"] += 1
        time.sleep(0.05)  # widen the window a racing thread would hit
        state["stale"] = False
        return {"fake": 0.05}

    class FakeLib:
        def __init__(self, path):
            counts["open"] += 1
            time.sleep(0.02)

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_stale", lambda src: state["stale"])
    monkeypatch.setattr(_build, "build_all", fake_build_all)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    got = []

    def first_use():
        barrier.wait(timeout=30)
        got.append(_build.load("seq_cumsum"))

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()
    assert counts == {"build": 1, "open": 1}
    assert got[0] is got[1]


class _YieldingCounter:
    """A ``launches`` whose read gives up the interpreter lock, so an
    unguarded read-modify-write from two threads loses updates."""

    def __init__(self):
        self._n = 0

    @property
    def launches(self):
        n = self._n
        time.sleep(0)
        return n

    @launches.setter
    def launches(self, value):
        self._n = value


@pytest.mark.parametrize("module", [k1, k2, k3, k4, "yielding"],
                         ids=["encode_step", "seq_cumsum", "dict_match",
                              "flash_decode", "yielding"])
def test_launch_counters_exact_under_threads(module, monkeypatch):
    """More threads than cores bump one counter with a short switch
    interval: a lost update would show in the total (the yielding counter
    loses most of them without the lock)."""
    if module == "yielding":
        module = _YieldingCounter()
    monkeypatch.setattr(module, "launches", 0)
    n, per = (os.cpu_count() or 2) + 2, 500

    def bump():
        for _ in range(per):
            _build.count_launch(module)

    threads = [threading.Thread(target=bump) for _ in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert module.launches == n * per


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_golden_streams_through_the_coalescer(name):
    """A golden case as one coalesced stream (fed in 100-sample submits,
    one flush a submit) equals the same stream through a per-stream port
    session fed the same chunks."""
    kw = _port_kw("cuda", **{k: v for k, v in
                             golden_codec_kwargs(name).items()
                             if k != "backend"})
    x = golden_signal(name)
    co = StreamCoalescer(policy=FlushPolicy(max_batch_streams=1),
                         dtype=x.dtype, **kw)
    co.open_stream("g")
    segs = [co.submit("g", x[lo:lo + 100]) or {}
            for lo in range(0, len(x), 100)]
    got = b"".join(s.get("g", b"") for s in segs) + co.close_stream("g")
    sess = IdealemCodec(**kw).session(dtype=x.dtype)
    want = b"".join([sess.feed(x[lo:lo + 100])
                     for lo in range(0, len(x), 100)] + [sess.finish()])
    assert got == want
