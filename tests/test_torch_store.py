"""The indexed store of the PyTorch port vs the JAX reference, on the CPU.

Container bytes are a format: the port's ``pack``, ``ContainerWriter`` and
``container=True`` sessions must give the reference's bytes exactly.  Range
reads must equal the same slice of the reference's full decode, bitwise, on
every port backend (``cuda`` on CPU tensors runs K2's plain version), and
walk only the chunks that cover them, as the reference's do.  Tolerance:
none anywhere (bytes and ``tobytes()`` equal).
"""
import os
import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import GOLDEN_CASES, golden_codec_kwargs, golden_signal  # noqa: E402
from repro import obs as jax_obs  # noqa: E402
from repro.core import IdealemCodec as JaxCodec  # noqa: E402
from repro.core import stream as jax_stream  # noqa: E402
from repro.core.stream import decode_stream as jax_decode_stream  # noqa: E402
from repro.store import Container as JaxContainer  # noqa: E402
from repro.store import decode_range as jax_decode_range  # noqa: E402
from repro.store import pack as jax_pack  # noqa: E402
from repro_torch import IdealemCodec, obs  # noqa: E402
from repro_torch.core import stream as stream_mod  # noqa: E402
from repro_torch.errors import ContainerFormatError, StreamFormatError  # noqa: E402
from repro_torch.kernels import seq_cumsum as k2  # noqa: E402
from repro_torch.store import (Container, ContainerWriter,  # noqa: E402
                               decode_channels, decode_range, decode_ranges,
                               pack)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
FEED = 100  # session chunk (samples) that makes multi-segment streams
BACKENDS = ["numpy", "torch", "cuda"]


def _golden_bytes(name):
    with open(os.path.join(GOLDEN_DIR, f"{name}.idlm"), "rb") as f:
        return f.read()


def _session_stream(name, feed=FEED):
    """The golden signal fed in chunks through the reference's numpy
    session: a multi-segment (FLAG_MORE/FLAG_CONT) stream."""
    codec = JaxCodec(**golden_codec_kwargs(name))
    x = golden_signal(name)
    s = codec.session()
    segs = [s.feed(x[lo:lo + feed]) for lo in range(0, len(x), feed)]
    segs.append(s.finish())
    return b"".join(segs)


def _read(store, requests, backend):
    return decode_ranges(store, requests, backend=backend, device="cpu")


def _all_ranges(nb):
    return [(0, i, j) for i in range(nb) for j in range(i + 1, nb + 1)]


def _forge_index(good, edit):
    """``good`` with ``edit(index: bytearray)`` applied to its index and
    the footer CRC recomputed, so only the structural checks can object."""
    foot = struct.Struct("<8sQII")
    magic, idx_off, idx_len, _ = foot.unpack_from(good, len(good) - foot.size)
    index = bytearray(good[idx_off:idx_off + idx_len])
    edit(index)
    return (good[:idx_off] + bytes(index)
            + foot.pack(magic, idx_off, idx_len, zlib.crc32(bytes(index))))


# ------------------------------------------------------------ bytes
@pytest.mark.parametrize("form", ["oneshot", "multisegment"])
@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_pack_equals_reference(name, form):
    blob = (_golden_bytes(name) if form == "oneshot"
            else _session_stream(name))
    got = pack(blob)
    assert got == jax_pack(blob)
    assert Container(got).describe() == JaxContainer(got).describe()


@pytest.mark.parametrize("channels", [None, 3])
@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_container_session_equals_reference(name, backend, channels):
    """A port ``container=True`` session writes the reference's container
    bytes: ``numpy`` against the reference's ``numpy`` backend, ``torch``
    against its ``jax`` backend (both scans decide in float32)."""
    kw = golden_codec_kwargs(name)
    kw.pop("backend")
    x = golden_signal(name)
    if channels is not None:
        x = np.stack([x, x[::-1].copy(), np.roll(x, 37)])
    sessions = [
        IdealemCodec(backend=backend, device="cpu", **kw).session(
            channels=channels, dtype=x.dtype, container=True),
        JaxCodec(backend="numpy" if backend == "numpy" else "jax",
                 **kw).session(channels=channels, dtype=x.dtype,
                               container=True)]
    for s in sessions:
        for lo in range(0, x.shape[-1], FEED):
            s.feed(x[..., lo:lo + FEED])
    got, want = (s.finish() for s in sessions)
    assert got == want
    assert Container(got).channels == list(range(channels or 1))


def test_container_session_emits_the_plain_session_bytes():
    """The container holds, per channel, exactly the segments a plain
    session emits on the same feeds."""
    kw = dict(mode="delta", block_size=16, num_dict=5, alpha=0.05,
              rel_tol=0.5, backend="cuda", device="cpu")
    x = np.stack([golden_signal("delta_D32"), golden_signal("std_D32")])
    plain, boxed = (IdealemCodec(**kw).session(channels=2, container=c)
                    for c in (False, True))
    parts = [[], []]
    for lo in range(0, x.shape[1], 64):
        for c, seg in enumerate(plain.feed(x[:, lo:lo + 64])):
            parts[c].append(seg)
        boxed.feed(x[:, lo:lo + 64])
    for c, seg in enumerate(plain.finish()):
        parts[c].append(seg)
    store = Container(boxed.finish())
    for c in range(2):
        assert store.stream_bytes(c) == b"".join(parts[c])


# ------------------------------------------------------------ ranges
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("form", ["oneshot", "multisegment"])
@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_all_ranges_equal_reference_full_decode(name, form, backend):
    """Every (i, j) of every golden stream, one-shot and multi-segment, in
    one batched read: each range equals the same slice of the reference's
    full decode."""
    blob = (_golden_bytes(name) if form == "oneshot"
            else _session_stream(name))
    y = jax_decode_stream(blob)
    store = Container(pack(blob))
    B = store.header_of(0).block_size
    reqs = _all_ranges(store.total_blocks(0))
    for (_, i, j), got in zip(reqs, _read(store, reqs, backend)):
        assert got.tobytes() == y[i * B:j * B].tobytes(), (i, j)
    full = decode_channels(store, backend=backend, device="cpu")[0]
    assert full.tobytes() == y.tobytes()


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_ranges_batched_equals_loop(backend):
    store = Container(pack(_session_stream("delta_D32")))
    nb = store.total_blocks(0)
    reqs = [(0, i, j) for i, j in [(0, nb), (3, 5), (nb - 1, nb), (7, 29)]]
    for (_, i, j), got in zip(reqs, _read(store, reqs, backend)):
        one = decode_range(store, i, j, backend=backend, device="cpu")
        assert got.tobytes() == one.tobytes()


def test_delta_batch_is_one_k2_call(monkeypatch):
    """On a delta container a ``decode_ranges`` call reaches K2's wrapper
    once, over the padded batch; ``backend="torch"`` never reaches it."""
    shapes = []
    real = k2.seq_cumsum

    def counted(x):
        shapes.append(tuple(x.shape))
        return real(x)

    monkeypatch.setattr(k2, "seq_cumsum", counted)
    store = Container(pack(_session_stream("delta_D32")))
    reqs = [(0, 0, 3), (0, 5, 30), (0, 39, 40)]
    want = _read(store, reqs, "numpy")
    got = _read(store, reqs, "cuda")
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
    assert shapes == [(128, 15)]  # 3 requests x 25 blocks, padded to 2**7
    _read(store, reqs, "torch")
    assert len(shapes) == 1


def test_multichannel_decode_channels_equals_reference():
    rng = np.random.default_rng(0)
    C = 3
    x = np.stack([rng.normal(c, 1.0, size=16 * 50 + 4) for c in range(C)])
    codec = JaxCodec(mode="residual", block_size=16, num_dict=8, alpha=0.05,
                     rel_tol=0.5, value_range=(-5.0, 9.0), backend="numpy")
    s = codec.session(channels=C)
    parts = [s.feed(x[:, :300]), s.feed(x[:, 300:]), s.finish()]
    per_chan = {c: b"".join(p[c] for p in parts) for c in range(C)}
    store = Container(pack(per_chan))
    assert store.channels == [0, 1, 2]
    for backend in BACKENDS:
        out = decode_channels(store, backend=backend, device="cpu")
        for c in range(C):
            assert out[c].tobytes() == \
                jax_decode_stream(per_chan[c]).tobytes()
            np.testing.assert_array_equal(store.tail(c), x[c][-4:])


def test_empty_tail_only_and_out_of_range():
    codec = IdealemCodec(mode="std", block_size=16, num_dict=4,
                         backend="numpy", device="cpu")
    for x in [np.zeros(0), np.arange(5, dtype=np.float64)]:
        store = Container(pack(codec.encode(x)))
        assert store.total_blocks(0) == 0
        np.testing.assert_array_equal(
            decode_channels(store, backend="numpy")[0], x)
        with pytest.raises(IndexError):
            decode_range(store, 0, 1, backend="numpy")
    store = Container(pack(_golden_bytes("std_D32")))
    nb = store.total_blocks(0)
    for bad in [(-1, 2), (0, nb + 1), (5, 5), (7, 3)]:
        with pytest.raises(IndexError):
            decode_range(store, *bad, backend="numpy")
    with pytest.raises(KeyError):
        decode_range(store, 0, 1, channel=9, backend="numpy")
    assert decode_ranges(store, [], backend="numpy") == []


def test_decode_seed_minus_one_equals_reference():
    blob = _golden_bytes("std_D32")
    store = Container(pack(blob))
    want = jax_decode_range(JaxContainer(pack(blob)), 0, 40, seed=-1)
    for backend in BACKENDS:
        got = decode_range(store, 0, 40, seed=-1, backend=backend,
                           device="cpu")
        assert got.tobytes() == want.tobytes()


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    store = Container(pack(_golden_bytes("delta_D32")))
    for call in (lambda: decode_channels(store),
                 lambda: decode_range(store, 0, 2),
                 lambda: decode_ranges(store, [(0, 0, 2)], backend="torch"),
                 lambda: decode_ranges(store, [])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ------------------------------------------------------------ locality
def _walks(port_read, ref_read):
    """Deltas of (segment walks, chunk-walk counter) of one read on the
    port and on the reference."""
    name = "repro_store_chunk_walks_total"
    out = []
    for read, walks, reg in ((port_read, stream_mod.segment_walk_count,
                              obs.registry()),
                             (ref_read, jax_stream.segment_walk_count,
                              jax_obs.registry())):
        w0, c0 = walks(), reg.get_value(name)
        read()
        out.append((walks() - w0, reg.get_value(name) - c0))
    return out


@pytest.mark.parametrize("rng_blocks,want", [
    ((17, 19), 1),      # inside one 4-block segment
    ((18, 22), 2),      # across a segment boundary
    ((0, None), None),  # the whole channel
])
def test_walks_grow_as_the_reference(rng_blocks, want):
    blob = _session_stream("std_D32", feed=4 * 16)
    store, ref = Container(pack(blob)), JaxContainer(jax_pack(blob))
    assert store.n_chunks >= 10
    i, j = rng_blocks
    j = store.total_blocks(0) if j is None else j
    port, jax_side = _walks(
        lambda: decode_range(store, i, j, backend="numpy"),
        lambda: jax_decode_range(ref, i, j))
    assert port == jax_side
    assert port[0] == port[1]
    if want is not None:
        assert port[0] == want
    else:
        assert port[0] >= 10


def test_seek_of_last_block_walks_one_segment():
    for feed in [64, 16 * 40 + 5]:
        store = Container(pack(_session_stream("delta_D1_vr", feed=feed)))
        nb = store.total_blocks(0)
        before = stream_mod.segment_walk_count()
        decode_range(store, nb - 1, nb, backend="numpy")
        assert stream_mod.segment_walk_count() - before == 1


# ------------------------------------------------------------ rejection
def test_container_rejects_corruption():
    good = pack(_golden_bytes("std_D32"))
    Container(good)
    with pytest.raises(ContainerFormatError, match="magic"):
        Container(b"NOTAPACK" + good[8:])
    with pytest.raises(ContainerFormatError, match="footer"):
        Container(good[:-8])
    with pytest.raises(ContainerFormatError, match="CRC"):
        flipped = bytearray(good)
        flipped[-30] ^= 0xFF  # inside the index
        Container(bytes(flipped))
    with pytest.raises(ContainerFormatError, match="version"):
        Container(good[:8] + struct.pack("<H", 9) + good[10:])
    for short in (good[:len(good) // 2], b""):
        with pytest.raises(ContainerFormatError):
            Container(short)


def test_container_rejects_out_of_region_snapshot():
    good = pack(_session_stream("std_D32"))
    store = Container(good)
    assert store.snapshot(store.n_chunks - 1).size > 0
    forged = _forge_index(
        good, lambda idx: struct.pack_into("<q", idx, len(idx) - 8, 10 ** 9))
    with pytest.raises(ContainerFormatError, match="snapshot offset"):
        Container(forged)


def test_snapshot_delta_rejects_bad_slot():
    good = pack(_session_stream("std_D32"))
    n_delta = int(Container(good)._cols["snap_delta"].sum())
    assert n_delta > 0

    def edit(idx):
        # the slots blob sits between the columns and the offsets blob
        idx[len(idx) - 8 * n_delta - n_delta] = 200

    with pytest.raises(ContainerFormatError, match="delta slot"):
        Container(_forge_index(good, edit))


def test_writer_rejects_malformed_appends():
    blob = _session_stream("std_D32")
    segs, _, _, _ = stream_mod._walk_all(memoryview(blob))
    seg_bytes = [blob[s.start:s.end] for s in segs]

    w = ContainerWriter()
    with pytest.raises(StreamFormatError, match="FLAG_CONT"):
        w.append(seg_bytes[1])  # a continuation cannot open a channel
    w = ContainerWriter()
    w.append(seg_bytes[0])
    with pytest.raises(StreamFormatError, match="FLAG_CONT"):
        w.append(seg_bytes[0])  # restarting mid-channel is rejected
    w = ContainerWriter()
    w.append(blob)  # the whole chain: its final segment closes the channel
    with pytest.raises(StreamFormatError, match="finished"):
        w.append(seg_bytes[1])
    w = ContainerWriter()
    w.append(seg_bytes[0])
    mutated = bytearray(seg_bytes[1])
    mutated[9] ^= 0x0F  # max_count: ignored by the D>=2 walk
    with pytest.raises(StreamFormatError, match="parameters"):
        w.append(bytes(mutated))
    w.finalize()
    with pytest.raises(RuntimeError, match="finalized"):
        w.append(seg_bytes[0])


# ------------------------------------------------------------ files
def test_writer_file_roundtrip_and_reopen(tmp_path):
    blob = _session_stream("residual_D32_vr")
    segs, _, _, _ = stream_mod._walk_all(memoryview(blob))
    seg_bytes = [blob[s.start:s.end] for s in segs]
    path = os.path.join(tmp_path, "t.idlmc")
    w = ContainerWriter(path)
    for sb in seg_bytes[:len(seg_bytes) // 2]:
        w.append(sb)
    assert w.finalize() is None
    tok1 = Container.open(path).cache_token
    w2 = ContainerWriter.reopen(path)
    for sb in seg_bytes[len(seg_bytes) // 2:]:
        w2.append(sb)
    w2.finalize()
    with open(path, "rb") as f:
        assert f.read() == jax_pack(blob)  # reopen-append == one-shot pack
    store = Container.open(path)
    assert store.stream_bytes(0) == blob
    assert store.cache_token != tok1 and store.cache_token[0] == tok1[0]
    y = jax_decode_stream(blob)
    nb = store.total_blocks(0)
    for i, j in [(0, nb), (nb // 2 - 1, nb // 2 + 2), (nb - 1, nb)]:
        got = decode_range(store, i, j, backend="cuda", device="cpu")
        assert got.tobytes() == y[i * 16:j * 16].tobytes()


def test_mmap_open_equals_in_memory(tmp_path):
    blob = _session_stream("delta_D32")
    path = os.path.join(tmp_path, "m.idlmc")
    assert pack(blob, path=path) is None
    mem = Container(pack(blob))
    with Container.open(path, mmap=True) as store:
        assert store._mmap is not None
        cv = store.chunk_bytes(0)
        assert isinstance(cv, memoryview)
        assert store.stream_bytes(0) == mem.stream_bytes(0) == blob
        assert store.describe() == mem.describe()
        nb = store.total_blocks(0)
        reqs = [(0, 0, nb), (0, 5, 9), (0, nb - 1, nb)]
        for a, b in zip(_read(store, reqs, "cuda"), _read(mem, reqs, "cuda")):
            assert a.tobytes() == b.tobytes()
        assert store.cache_token == Container.open(path).cache_token
        del cv  # an exported view must go before close()
    assert store._mmap is None


def test_snapshot_delta_index_equals_reference():
    """A high-D channel cut into 1-block segments: the delta index is far
    smaller than full snapshots, and equal to the reference's."""
    B, D, warm, cruise = 8, 48, 48, 200
    rng = np.random.default_rng(7)
    x = np.concatenate([
        (np.arange(warm) * 50.0).repeat(B) + rng.normal(0, 0.1, warm * B),
        (rng.integers(0, D, size=cruise) * 50.0).repeat(B)
        + rng.normal(0, 0.1, cruise * B)])
    codec = IdealemCodec(mode="std", block_size=B, num_dict=D, alpha=0.05,
                         rel_tol=0.5, backend="numpy", device="cpu")
    s = codec.session(container=True)
    for lo in range(0, len(x), B):
        s.feed(x[lo:lo + B])
    got = s.finish()
    store = Container(got)
    assert got == jax_pack(store.stream_bytes(0))
    info = store.describe()
    assert info["snapshot_delta_entries"] <= store.n_chunks
    assert info["snapshot_delta_entries"] < info["snapshot_entries"] / 20
