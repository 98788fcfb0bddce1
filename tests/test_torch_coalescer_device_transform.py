"""The coalescer's device transform, on the CPU.

A residual or delta ``StreamCoalescer`` of float64 streams without a plan
stages raw blocks, transforms the whole flush with
``core/transforms.py``'s tensor twins and brings the float64 payload back
in the flush's copy out.  Held here: every stream's bytes equal a
per-stream ``IdealemSession`` on the host transform fed the same runs
(ragged chunks, sub-block tails, a closed stream's slot reused; planted
deltas and residuals of exactly +-180 and +-360, values outside the
range, NaN and +-inf), the float32 input the scan decides on is NumPy's
cast of the host payload bit for bit, and
``repro_encode_transform_blocks_total{where}`` counts each block where
its transform ran.  The torch backend on ``device="cpu"`` takes the same
branch as the card.  Tolerance: none (bits equal).  Wiring tests read
deltas of the process-default registry, which other tests also write.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import IdealemCodec  # noqa: E402
from repro_torch.data.synthetic import pmu_angle  # noqa: E402
from repro_torch.serve import (CompressionService, FlushPolicy,  # noqa: E402
                               StreamCoalescer)
from repro_torch.serve import compress  # noqa: E402

B = 16
VR = (0.0, 360.0)
# one block of planted samples: deltas of +180, -180, +360, -360 and
# residuals (base 10) of +-180, +-360, out-of-range values on both sides
EDGE = np.array([10.0, 190.0, 10.0, 370.0, 10.0, -170.0, -350.0, 725.0,
                 -5.5, 174.5, -185.5, 360.0, 0.0, 360.0, 720.0, -360.0])
NONFINITE = np.array([10.0, np.nan, 20.0, np.inf, 30.0, -np.inf, -np.inf,
                      np.inf, -np.nan, 5.0, 6.0, np.nan, 7.0, 8.0, 9.0,
                      10.0])


def _kw(mode, value_range, **kw):
    return dict(mode=mode, block_size=B, num_dict=8, alpha=0.05,
                rel_tol=0.5, value_range=value_range, backend="torch",
                device="cpu", **kw)


def _signal(n, seed, nonfinite=False):
    """A wrapping phase-angle ramp with the edge block planted at every
    fifth block (and the non-finite block at every seventh)."""
    x = pmu_angle(n, seed=seed)
    for b in range(2, n // B, 5):
        x[b * B:(b + 1) * B] = EDGE
    if nonfinite:
        for b in range(3, n // B, 7):
            x[b * B:(b + 1) * B] = NONFINITE
    return x


def _count(where):
    return obs.registry().get_value("repro_encode_transform_blocks_total",
                                    {"where": where})


def _flushed_blocks():
    for v in obs.registry().snapshot()["repro_encode_flush_blocks"][
            "values"]:
        if not v["labels"]:
            return v["sum"]
    return 0.0


def _drive(co, signals, rounds, seed):
    """Ragged submits (some under a block), one flush a round; stream
    ``s0`` closes halfway and ``s9`` opens in its slot.  Returns each
    stream's bytes and the sample runs its flushes took."""
    rng = np.random.default_rng(seed)
    live = [s for s in signals if s != "s9"]
    for sid in live:
        co.open_stream(sid)
    segs = {sid: [] for sid in signals}
    feeds = {sid: [] for sid in signals}
    offs = dict.fromkeys(signals, 0)
    for r in range(rounds):
        if r == rounds // 2:
            segs["s0"].append(co.close_stream("s0"))
            feeds["s0"].append(None)  # the close: finish()
            live.remove("s0")
            co.open_stream("s9")
            live.append("s9")
        for sid in live:
            n = int(rng.integers(1, 5 * B))
            chunk = signals[sid][offs[sid]:offs[sid] + n]
            offs[sid] += n
            co.submit(sid, chunk)
            feeds[sid].append(chunk)
        for sid, seg in co.flush().items():
            segs[sid].append(seg)
    for sid in live:
        segs[sid].append(co.close_stream(sid))
        feeds[sid].append(None)
    return {s: b"".join(v) for s, v in segs.items()}, feeds


def _host_bytes(kw, feeds):
    """A per-stream host session fed the same chunks (each round's chunk
    is what the round's flush took from the stream)."""
    sess = IdealemCodec(**kw).session()
    out = [sess.finish() if f is None else sess.feed(f) for f in feeds]
    return b"".join(out)


def _check_bytes(kw, nonfinite):
    """Four streams through a coalescer that grows from 2 slots: bytes
    equal host sessions', and the counters count where each block ran."""
    signals = {f"s{k}": _signal(B * 120, seed=k, nonfinite=nonfinite)
               for k in (0, 1, 2, 9)}
    co = StreamCoalescer(policy=FlushPolicy(max_batch_blocks=10 ** 9),
                         capacity=2, block_bucket=8, **kw)
    dev0, host0, blocks0 = _count("device"), _count("host"), \
        _flushed_blocks()
    with np.errstate(invalid="ignore"):
        got, feeds = _drive(co, signals, rounds=12, seed=7)
        assert co.capacity == 4  # grew under a live carry
        assert _count("device") - dev0 == _flushed_blocks() - blocks0 > 0
        # blocks holding a NaN are transformed again on the host
        assert (_count("host") > host0) == nonfinite
        for sid, f in feeds.items():
            assert got[sid] == _host_bytes(kw, f), sid


@pytest.mark.parametrize("nonfinite", [False, True])
@pytest.mark.parametrize("value_range", [None, VR])
@pytest.mark.parametrize("mode", ["delta", "residual"])
def test_device_transform_bytes_equal_host_sessions(mode, value_range,
                                                    nonfinite):
    _check_bytes(_kw(mode, value_range), nonfinite)


@pytest.mark.cuda
@pytest.mark.parametrize("nonfinite", [False, True])
@pytest.mark.parametrize("value_range", [None, VR])
@pytest.mark.parametrize("mode", ["delta", "residual"])
def test_card_transform_bytes_equal_host_sessions(mode, value_range,
                                                  nonfinite):
    """The same on the card (``backend="cuda"``, K1): the card's
    arithmetic, its NaNs' bits included, gives the host path's bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    _check_bytes(dict(_kw(mode, value_range), backend="cuda",
                      device="cuda"), nonfinite)


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("mode", ["delta", "residual"])
def test_scan_input_is_float32_of_host_payload(mode, device, monkeypatch):
    """The float32 batch the scan decides on equals NumPy's cast of the
    host transform's payload bit for bit, and its padding is zero, as the
    host-staged batch was (on the card too, with ``backend="cuda"``).
    The host buffers start as NaN garbage: staging writes every element."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    seen = []
    real = compress.encode_decisions_batched
    empty = StreamCoalescer._host_empty

    def spy(xs, **kw):
        seen.append(xs.cpu().clone())
        return real(xs, **kw)

    def garbage(self, shape):
        return empty(self, shape).fill_(float("nan"))

    monkeypatch.setattr(compress, "encode_decisions_batched", spy)
    monkeypatch.setattr(StreamCoalescer, "_host_empty", garbage)
    kw = _kw(mode, VR)
    if device == "cuda":
        kw.update(backend="cuda", device="cuda")
    codec = IdealemCodec(**kw)
    co = StreamCoalescer(capacity=4, block_bucket=8, **kw)
    rng = np.random.default_rng(11)
    x = {}
    for k in range(3):
        sid = f"s{k}"
        co.open_stream(sid)
        x[sid] = _signal(B * (20 + 7 * k), seed=100 + k)
        co.submit(sid, x[sid][:B * (20 + 7 * k) - int(rng.integers(0, B))])
    segs = co.flush()
    (xs,) = seen
    assert xs.dtype == torch.float32 and tuple(xs.shape) == (4, 40, B - 1)
    xs = xs.numpy()
    for k, (sid, sig) in enumerate(x.items()):
        nb = co.stats(sid)["blocks"]
        blocks = sig[:nb * B].reshape(nb, B)
        want = codec._transform(blocks)[0].astype(np.float32)
        np.testing.assert_array_equal(xs[k, :nb].view(np.uint32),
                                      want.view(np.uint32))
        assert not xs[k, nb:].any()
        sess = IdealemCodec(**kw).session()
        assert segs[sid] == sess.feed(sig[:nb * B])
    assert not xs[3].any()


def test_transform_counter_by_where(monkeypatch):
    """``where="device"`` counts a delta coalescer's flushed blocks,
    ``where="host"`` a ``CompressionService`` feed's and a float32
    coalescer's (which keeps the host transform); a std coalescer counts
    nothing and still stages float32 payloads on the host."""
    staged = []
    real = StreamCoalescer._stage

    def spy(self, prepared, nb_pad, raw):
        batch, valid = real(self, prepared, nb_pad, raw)
        staged.append((raw, batch.dtype, batch.shape[-1]))
        return batch, valid

    monkeypatch.setattr(StreamCoalescer, "_stage", spy)
    x = _signal(B * 30 + 5, seed=3)

    def coalesce(mode, **kw):
        co = StreamCoalescer(capacity=2, block_bucket=8,
                             **_kw(mode, VR if mode != "std" else None),
                             **kw)
        co.open_stream("a")
        co.submit("a", x)
        return co.close_stream("a")

    dev0, host0 = _count("device"), _count("host")
    coalesce("delta")
    assert (_count("device") - dev0, _count("host") - host0) == (30, 0)
    assert staged[-1] == (True, np.float64, B)

    svc = CompressionService(**_kw("delta", VR))
    svc.open_stream("a")
    svc.feed("a", x)
    svc.close_stream("a")
    assert (_count("device") - dev0, _count("host") - host0) == (30, 30)

    coalesce("residual", dtype=np.float32)
    assert (_count("device") - dev0, _count("host") - host0) == (30, 60)
    assert staged[-1] == (False, np.float32, B - 1)

    coalesce("std")
    assert (_count("device") - dev0, _count("host") - host0) == (30, 60)
    assert staged[-1] == (False, np.float32, B)
