"""Random-access container format for IDEALEM streams: the reference
package's format, byte for byte.

A raw ``.idlm`` stream is a chain of segments that can only be decoded by
walking every decision byte from the front: segment boundaries, the FIFO
fill counter and the dictionary contents are all implicit in the bytes that
came before.  The container wraps one or more streams (one per *channel*)
with a footer index that makes every segment seekable:

  file   := file-header | chunk* | index | footer
  chunk  := one verbatim ``.idlm`` segment (header + body, untouched)
  index  := per-chunk records + dictionary snapshots (below)
  footer := index offset/length + CRC-32, fixed size, at the very end

Per chunk the index records the byte offset/length, the channel, the block
count and per-channel cumulative block count, the CONT/MORE/tail flags, the
FIFO fill counter *entering* the segment, and the nearest clean restart
point (a segment is independently decodable from empty state iff it is not
FLAG_CONT and enters with an empty dictionary; within a channel that is its
first segment).  The *dictionary snapshot* is what buys true random access:
for every slot valid at segment entry, the absolute byte offset of the
payload of the most recent miss written to that slot.  A reader can
therefore start parsing at ANY segment -- carried dictionary entries are
gathered straight from the snapshot offsets instead of replaying history
(``repro_torch.store.reader``).

Snapshots are stored as *deltas* (container v2): per chunk, only the
``(slot, offset)`` pairs that changed since the previous chunk of the same
channel -- i.e. the slots the previous segment's misses touched.  A full
snapshot per chunk is O(chunks x D); for a high-D channel cut into many
tiny segments the delta form shrinks the index to O(total misses), and the
reader reassembles the full per-chunk snapshots once at open time.

Chunks are byte-verbatim segments, so concatenating a channel's chunks
reproduces the original stream exactly; ``pack``/``append`` never re-encode.
The strict reader validates both magics, the version, the footer CRC and
the structural invariants before trusting any offset.  ``Container.open``
can back the data region with a read-only ``mmap`` so archives larger than
RAM are served zero-copy (chunks are ``memoryview`` slices into the map;
only the index is materialized).
"""
from __future__ import annotations

import io
import itertools
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np

from ..core import stream as stream_mod
from ..core.stream import StreamHeader
from ..errors import ContainerFormatError, StreamFormatError

__all__ = [
    "ContainerFormatError",
    "Container",
    "ContainerWriter",
    "pack",
]

FILE_MAGIC = b"IDLMPAK1"
FOOTER_MAGIC = b"IDLXFTR1"
CONTAINER_VERSION = 2    # v2: dictionary snapshots stored as deltas
_FILE_HDR = struct.Struct("<8sH6x")      # 16 bytes
_FOOTER = struct.Struct("<8sQII")        # 24 bytes: magic, off, len, crc
_INDEX_HDR = struct.Struct("<IHH")       # n_chunks, n_channels, reserved

# Monotonic token source for containers without a backing file, so parsed-
# chunk caches keyed on ``cache_token`` can never alias two distinct
# in-memory containers (an ``id()`` could be recycled after GC).
_MEM_TOKENS = itertools.count()

CHUNK_CONT = 1    # segment continues the previous segment's dictionary
CHUNK_MORE = 2    # another segment follows in this channel's stream
CHUNK_TAIL = 4    # segment header carries a non-empty sample tail

# (name, dtype) pairs of the fixed per-chunk index columns, in file order.
_COLUMNS = [
    ("channel", "<u2"),
    ("offset", "<u8"),
    ("length", "<u4"),
    ("n_blocks", "<u4"),
    ("blocks_before", "<u8"),
    ("fill_in", "<u2"),
    ("flags", "u1"),
    ("restart", "<u4"),
]



# --------------------------------------------------------------------- writer

@dataclass
class _ChannelState:
    """Writer-side running state of one channel's stream."""

    header: StreamHeader              # first segment's header (param source)
    fill: int = 0                     # FIFO fill counter after last segment
    blocks: int = 0                   # total blocks appended
    restart: int = 0                  # container chunk id of the stream start
    finished: bool = False            # a non-MORE segment has been appended
    snap: np.ndarray = field(
        default_factory=lambda: np.full(0, -1, dtype=np.int64))

    def params(self):
        h = self.header
        return (h.mode, h.block_size, h.num_dict, h.max_count,
                np.dtype(h.dtype), h.value_range)


class ContainerWriter:
    """Incremental container writer.

    ``append(data, channel)`` accepts one segment or a chain of segments
    (e.g. everything an ``IdealemSession`` has emitted so far) and writes
    them as index-tracked chunks; ``finalize()`` writes the index + footer.
    With no ``path`` the container is built in memory and ``finalize``
    returns the bytes.  ``ContainerWriter.reopen`` resumes appending to an
    existing container file: the index carries enough state (fill counters,
    snapshots) to continue any unfinished channel.
    """

    def __init__(self, path: Optional[str] = None):
        self._own: Optional[io.BytesIO] = None
        if path is None:
            self._f = self._own = io.BytesIO()
        else:
            self._f = open(path, "wb")
        self._f.write(_FILE_HDR.pack(FILE_MAGIC, CONTAINER_VERSION))
        self._pos = _FILE_HDR.size
        self._chan: Dict[int, _ChannelState] = {}
        self._records: List[tuple] = []   # per-chunk fixed columns
        self._snaps: List[np.ndarray] = []
        self._finalized = False

    # -- lifecycle ---------------------------------------------------------
    def append(self, data: bytes, channel: int = 0) -> None:
        """Append one segment -- or a back-to-back chain of segments -- to
        ``channel``.  Segments are stored verbatim; the index entry (fill
        counter, dictionary snapshot, cumulative blocks) is derived by
        walking the decision bytes once, right here."""
        if self._finalized:
            raise RuntimeError("container already finalized")
        if not (0 <= channel < 2 ** 16):
            raise ValueError("channel must fit in uint16")
        if len(data) == 0:
            return
        st = self._chan.get(channel)
        buf = memoryview(data)
        # validate the leading segment's framing BEFORE walking: a segment
        # fed with the wrong carried fill counter walks as garbage, which
        # would mask the real mistake (wrong CONT flag) behind a walk error
        hdr0, _ = stream_mod._unpack_header(buf, 0)
        if st is None and hdr0.cont:
            raise StreamFormatError(
                f"channel {channel}: first segment sets FLAG_CONT", 0)
        if st is not None and not hdr0.cont:
            raise StreamFormatError(
                f"channel {channel}: mid-stream segment without FLAG_CONT "
                "(stream restarts are not supported)", 0)
        segs, is_hit, slot, ovw = stream_mod._walk_all(
            buf, 0, st.fill if st else 0, till_end=True)
        for seg in segs:
            st = self._append_seg(channel, buf, seg, is_hit, slot, ovw)

    def _append_seg(self, channel, buf, seg, is_hit, slot, ovw):
        hdr = seg.header
        st = self._chan.get(channel)
        if st is None:
            if hdr.cont:
                raise StreamFormatError(
                    f"channel {channel}: first segment sets FLAG_CONT",
                    seg.start)
            st = self._chan[channel] = _ChannelState(
                header=hdr, restart=len(self._records),
                snap=np.full(hdr.num_dict, -1, dtype=np.int64))
        else:
            if st.finished:
                raise StreamFormatError(
                    f"channel {channel}: stream already finished", seg.start)
            if not hdr.cont:
                raise StreamFormatError(
                    f"channel {channel}: mid-stream segment without "
                    "FLAG_CONT (stream restarts are not supported)",
                    seg.start)
            if st.params() != _ChannelState(header=hdr).params():
                raise StreamFormatError(
                    f"channel {channel}: segment codec parameters changed",
                    seg.start)

        file_off = self._pos
        delta = file_off - seg.start  # segment buffer -> file offsets
        flags = ((CHUNK_CONT if hdr.cont else 0)
                 | (CHUNK_MORE if hdr.more else 0)
                 | (CHUNK_TAIL if len(hdr.tail) else 0))
        self._records.append((
            channel, file_off, seg.end - seg.start, seg.n_blocks, st.blocks,
            seg.fill_in, flags, st.restart,
        ))
        self._snaps.append(st.snap[:seg.fill_in].copy())

        # fold this segment's misses into the channel's snapshot state
        h = is_hit[seg.i0:seg.i0 + seg.n_blocks]
        if seg.n_blocks:
            o = ovw[seg.i0:seg.i0 + seg.n_blocks]
            s = slot[seg.i0:seg.i0 + seg.n_blocks]
            _, pay = stream_mod._segment_offsets(
                hdr, seg.body_start + delta, h, o, hdr.cont)
            np.maximum.at(st.snap, s[~h], pay)
        st.fill = min(st.fill + int(np.sum(~h)), hdr.num_dict)
        st.blocks += seg.n_blocks
        st.finished = not hdr.more

        self._f.write(buf[seg.start:seg.end])
        self._pos += seg.end - seg.start
        return st

    def finalize(self) -> Optional[bytes]:
        """Write the index + footer.  Returns the container bytes when
        writing in memory, ``None`` when backed by a file (closed here)."""
        if self._finalized:
            raise RuntimeError("container already finalized")
        self._finalized = True
        index = self._serialize_index()
        self._f.write(index)
        self._f.write(_FOOTER.pack(FOOTER_MAGIC, self._pos, len(index),
                                   zlib.crc32(index)))
        if self._own is not None:
            out = self._own.getvalue()
            self._own.close()
            return out
        self._f.close()
        return None

    # -- internals ---------------------------------------------------------
    def _serialize_index(self) -> bytes:
        """Index layout (v2): header | fixed columns | per-chunk delta
        count (u2) | delta slots (u8) | delta offsets (i8).

        The writer keeps FULL per-chunk snapshots in memory (``reopen``
        needs them); only serialization diffs consecutive snapshots of the
        same channel.  The first chunk of a channel enters with an empty
        dictionary, so its delta is empty too; growth slots (fill_in rose)
        always diff against the -1 sentinel and are therefore emitted."""
        n = len(self._records)
        cols = list(zip(*self._records)) if n else [[] for _ in _COLUMNS]
        parts = [_INDEX_HDR.pack(n, len(self._chan), 0)]
        for (name, dt), col in zip(_COLUMNS, cols):
            parts.append(np.asarray(col, dtype=dt).tobytes())
        counts = np.zeros(n, dtype="<u2")
        slot_parts, off_parts = [], []
        prev: Dict[int, np.ndarray] = {}
        for k, (rec, snap) in enumerate(zip(self._records, self._snaps)):
            ch = int(rec[0])
            p = prev.get(ch, np.zeros(0, np.int64))
            base = np.full(len(snap), -1, dtype=np.int64)
            base[:len(p)] = p  # fill never shrinks: len(p) <= len(snap)
            ds = np.flatnonzero(base != snap)
            counts[k] = len(ds)
            slot_parts.append(ds.astype(np.uint8))
            off_parts.append(snap[ds])
            prev[ch] = snap
        parts.append(counts.tobytes())
        parts.append((np.concatenate(slot_parts) if slot_parts
                      else np.zeros(0, np.uint8)).tobytes())
        parts.append((np.concatenate(off_parts) if off_parts
                      else np.zeros(0, np.int64)).astype("<i8").tobytes())
        return b"".join(parts)

    @classmethod
    def reopen(cls, path: str) -> "ContainerWriter":
        """Resume appending to an existing container file: restore the
        per-channel writer state from the index, truncate the old
        index + footer, and keep writing chunks."""
        src = Container.open(path)
        w = cls.__new__(cls)
        w._own = None
        w._f = open(path, "r+b")
        w._f.seek(src.data_end)
        w._f.truncate()
        w._pos = src.data_end
        w._records = [tuple(int(src._cols[name][i]) for name, _ in _COLUMNS)
                      for i in range(src.n_chunks)]
        w._snaps = [src.snapshot(i).copy() for i in range(src.n_chunks)]
        w._finalized = False
        w._chan = {}
        buf = memoryview(src.data)
        for c in src.channels:
            ks = src.chunks_of(c)
            last = int(ks[-1])
            hdr0 = src.header_of(int(ks[0]))
            st = _ChannelState(
                header=hdr0, restart=int(src._cols["restart"][last]),
                snap=np.full(hdr0.num_dict, -1, dtype=np.int64))
            st.snap[:len(src.snapshot(last))] = src.snapshot(last)
            # exit state of the last chunk = its entry snapshot + its misses
            hdr_l, off = stream_mod._unpack_header(
                buf, int(src._cols["offset"][last]))
            hb, sb, ob = bytearray(), bytearray(), bytearray()
            stream_mod._walk_segment(buf, off, hdr_l,
                                     int(src._cols["fill_in"][last]),
                                     hb, sb, ob)
            h = np.frombuffer(hb, np.uint8).astype(bool)
            if len(h):
                _, pay = stream_mod._segment_offsets(
                    hdr_l, off, h, np.frombuffer(ob, np.uint8).astype(bool),
                    hdr_l.cont)
                np.maximum.at(st.snap,
                              np.frombuffer(sb, np.uint8)[~h].astype(np.int64),
                              pay)
            st.fill = min(int(src._cols["fill_in"][last]) + int(np.sum(~h)),
                          hdr0.num_dict)
            st.blocks = src.total_blocks(c)
            st.finished = not hdr_l.more
            w._chan[int(c)] = st
        return w


def pack(streams: Union[bytes, Sequence[bytes], Mapping[int, bytes]],
         path: Optional[str] = None) -> Optional[bytes]:
    """One-shot packer: wrap finished ``.idlm`` stream(s) in a container.

    ``streams`` is a single stream (channel 0), a sequence (channel = list
    position) or a mapping ``{channel: stream}`` -- e.g. the per-channel
    blobs of a multi-channel session.  Returns the container bytes (or
    ``None`` after writing to ``path``)."""
    if isinstance(streams, (bytes, bytearray, memoryview)):
        streams = {0: bytes(streams)}
    elif not isinstance(streams, Mapping):
        streams = dict(enumerate(streams))
    w = ContainerWriter(path)
    for channel in sorted(streams):
        w.append(streams[channel], channel=channel)
    return w.finalize()


# --------------------------------------------------------------------- reader

class Container:
    """Strict random-access reader over a packed container.

    Validation happens once, at construction: both magics, the version, the
    footer CRC over the index bytes, and the structural invariants (chunk
    extents inside the data region, per-channel block continuity, snapshot
    sizes).  After that every accessor is O(1) numpy indexing; segment
    bodies are only ever walked by the range decoder, and only for the
    chunks a request actually covers."""

    def __init__(self, data, source_path: Optional[str] = None):
        self.data = data  # bytes, or any buffer (e.g. a read-only mmap)
        self._mmap = None
        self._file = None
        buf = memoryview(data)
        if len(data) < _FILE_HDR.size + _FOOTER.size:
            raise ContainerFormatError("container shorter than its framing")
        magic, ver = _FILE_HDR.unpack_from(buf, 0)
        if magic != FILE_MAGIC:
            raise ContainerFormatError("bad container magic")
        if ver != CONTAINER_VERSION:
            raise ContainerFormatError(f"unsupported container version {ver}")
        fmagic, idx_off, idx_len, crc = _FOOTER.unpack_from(
            buf, len(data) - _FOOTER.size)
        if fmagic != FOOTER_MAGIC:
            raise ContainerFormatError("bad footer magic")
        if not (_FILE_HDR.size <= idx_off
                and idx_off + idx_len + _FOOTER.size == len(data)):
            raise ContainerFormatError("index extent inconsistent with file "
                                       "size")
        index = bytes(buf[idx_off:idx_off + idx_len])
        del buf  # release the exported view (mmap.close() would refuse)
        if zlib.crc32(index) != crc:
            raise ContainerFormatError("index CRC mismatch")
        #: footer CRC doubles as the container *generation*: two opens of
        #: the same (unmodified) file share it, a reopen-append changes it.
        self.generation = int(crc)
        #: identity for parsed-chunk caches: containers opened from the
        #: same file generation share cached walks.
        if source_path is not None:
            self.cache_token = (os.path.abspath(source_path), self.generation)
        else:
            self.cache_token = ("mem", next(_MEM_TOKENS))
        self.source_path = source_path
        self.data_end = idx_off
        self._parse_index(index)
        self._check_invariants()

    @classmethod
    def open(cls, path: str, mmap: bool = False) -> "Container":
        """Open a container file.  With ``mmap=True`` the data region is a
        read-only memory map: chunk accesses are zero-copy ``memoryview``
        slices into the page cache, so archives larger than RAM serve
        range reads without ever materializing the file.  Call ``close()``
        (or use the container as a context manager) to drop the map; views
        handed out by ``chunk_bytes`` must not outlive it."""
        if not mmap:
            with open(path, "rb") as f:
                return cls(f.read(), source_path=path)
        import mmap as mmap_mod
        f = open(path, "rb")
        try:
            mm = mmap_mod.mmap(f.fileno(), 0, access=mmap_mod.ACCESS_READ)
        except Exception:
            f.close()
            raise
        try:
            store = cls(mm, source_path=path)
        except Exception:
            mm.close()
            f.close()
            raise
        store._mmap, store._file = mm, f
        return store

    def close(self) -> None:
        """Release the backing mmap/file (no-op for in-memory containers)."""
        if self._mmap is not None:
            self._mmap.close()
            self._file.close()
            self._mmap = self._file = None

    def __enter__(self) -> "Container":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- index parsing -----------------------------------------------------
    def _parse_index(self, index: bytes) -> None:
        try:
            n, n_chan, _ = _INDEX_HDR.unpack_from(index, 0)
        except struct.error:
            raise ContainerFormatError("truncated index header") from None
        off = _INDEX_HDR.size
        self.n_chunks = n
        self._cols: Dict[str, np.ndarray] = {}
        for name, dt in _COLUMNS:
            width = n * np.dtype(dt).itemsize
            if off + width > len(index):
                raise ContainerFormatError(f"index column {name} truncated")
            self._cols[name] = np.frombuffer(index, dtype=dt, count=n,
                                             offset=off).astype(np.int64)
            off += width
        # snapshot deltas: per-chunk count, then slot/offset blobs (v2)
        if off + 2 * n > len(index):
            raise ContainerFormatError("snapshot delta counts truncated")
        counts = np.frombuffer(index, dtype="<u2", count=n,
                               offset=off).astype(np.int64)
        off += 2 * n
        n_delta = int(counts.sum())
        if off + n_delta + 8 * n_delta != len(index):
            raise ContainerFormatError("snapshot delta blob size mismatch")
        d_slots = np.frombuffer(index, dtype=np.uint8, count=n_delta,
                                offset=off).astype(np.int64)
        d_offs = np.frombuffer(index, dtype="<i8", count=n_delta,
                               offset=off + n_delta).astype(np.int64)
        self._cols["snap_delta"] = counts
        self._snap_start = np.concatenate(
            [[0], np.cumsum(self._cols["fill_in"])]).astype(np.int64)
        self._snaps = self._reassemble_snapshots(counts, d_slots, d_offs)
        self.channels = sorted(int(c)
                               for c in np.unique(self._cols["channel"]))
        if len(self.channels) != n_chan:
            raise ContainerFormatError("channel count mismatch")
        self._by_channel = {
            c: np.flatnonzero(self._cols["channel"] == c)
            for c in self.channels
        }

    def _reassemble_snapshots(self, counts: np.ndarray, d_slots: np.ndarray,
                              d_offs: np.ndarray) -> np.ndarray:
        """Rebuild the full per-chunk snapshots from the delta form, once,
        at open time: per channel, each chunk's entering snapshot is the
        previous chunk's plus its ``(slot, offset)`` deltas (growth slots
        appear as deltas against the -1 sentinel, which
        ``_check_invariants`` then rejects if any slot was never set)."""
        fill = self._cols["fill_in"]
        snaps = np.full(int(fill.sum()), -1, dtype=np.int64)
        dstart = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        prev: Dict[int, np.ndarray] = {}
        for k in range(self.n_chunks):
            ch = int(self._cols["channel"][k])
            f = int(fill[k])
            cur = np.full(f, -1, dtype=np.int64)
            p = prev.get(ch)
            if p is not None:
                if len(p) > f:
                    raise ContainerFormatError(
                        f"chunk {k}: fill counter shrank within channel {ch}")
                cur[:len(p)] = p
            sl = d_slots[dstart[k]:dstart[k + 1]]
            if len(sl) and (f == 0 or int(sl.max()) >= f):
                raise ContainerFormatError(
                    f"chunk {k}: snapshot delta slot outside the fill range")
            cur[sl] = d_offs[dstart[k]:dstart[k + 1]]
            snaps[self._snap_start[k]:self._snap_start[k + 1]] = cur
            prev[ch] = cur
        return snaps

    def _check_invariants(self) -> None:
        cols = self._cols
        ends = cols["offset"] + cols["length"]
        if self.n_chunks:
            if int(cols["offset"].min()) < _FILE_HDR.size:
                raise ContainerFormatError("chunk overlaps the file header")
            if int(ends.max()) > self.data_end:
                raise ContainerFormatError("chunk overruns the data region")
            if np.any(cols["length"] <= 0):
                raise ContainerFormatError("zero-length chunk")
        if np.any(self._snaps < 0):
            raise ContainerFormatError("negative snapshot offset")
        for c, ks in self._by_channel.items():
            # snapshot offsets are trusted by the range decoder's payload
            # gather: every one must hold a full payload row inside the
            # data region
            hdr = self.header_of(int(ks[0]))
            P = (hdr.block_size if hdr.mode == stream_mod.MODE_STD
                 else hdr.block_size - 1)
            width = P * np.dtype(hdr.dtype).itemsize
            snaps = [self.snapshot(int(k)) for k in ks]
            snaps = np.concatenate(snaps) if snaps else np.zeros(0, np.int64)
            if len(snaps) and (int(snaps.min()) < _FILE_HDR.size
                               or int(snaps.max()) + width > self.data_end):
                raise ContainerFormatError(
                    f"channel {c}: snapshot offset outside the data region")
            bb = cols["blocks_before"][ks]
            nb = cols["n_blocks"][ks]
            if np.any(bb != np.concatenate([[0], np.cumsum(nb)[:-1]])):
                raise ContainerFormatError(
                    f"channel {c}: cumulative block counts are inconsistent")
            r = cols["restart"][ks]
            if np.any(r != ks[0]):
                raise ContainerFormatError(
                    f"channel {c}: restart points outside the channel")

    # -- accessors ---------------------------------------------------------
    def chunks_of(self, channel: int) -> np.ndarray:
        """Container chunk ids of ``channel``'s segments, in stream order."""
        try:
            return self._by_channel[channel]
        except KeyError:
            raise KeyError(f"no channel {channel} in container") from None

    def chunk_bytes(self, chunk: int) -> memoryview:
        off = int(self._cols["offset"][chunk])
        n = int(self._cols["length"][chunk])
        return memoryview(self.data)[off:off + n]

    def header_of(self, chunk: int) -> StreamHeader:
        hdr, _ = stream_mod._unpack_header(
            memoryview(self.data), int(self._cols["offset"][chunk]))
        return hdr

    def snapshot(self, chunk: int) -> np.ndarray:
        """Dictionary snapshot entering ``chunk``: absolute payload byte
        offset of the live miss for every valid slot (slot order)."""
        return self._snaps[self._snap_start[chunk]:self._snap_start[chunk + 1]]

    def total_blocks(self, channel: int = 0) -> int:
        ks = self.chunks_of(channel)
        return int(self._cols["blocks_before"][ks[-1]]
                   + self._cols["n_blocks"][ks[-1]])

    def tail(self, channel: int = 0) -> np.ndarray:
        """Sample tail of the channel's final segment (may be empty)."""
        last = int(self.chunks_of(channel)[-1])
        if not (self._cols["flags"][last] & CHUNK_TAIL):
            hdr = self.header_of(int(self.chunks_of(channel)[0]))
            return np.zeros(0, dtype=hdr.dtype)
        return self.header_of(last).tail

    def stream_bytes(self, channel: int = 0) -> bytes:
        """Reassemble the channel's original ``.idlm`` stream verbatim."""
        return b"".join(bytes(self.chunk_bytes(int(k)))
                        for k in self.chunks_of(channel))

    def describe(self) -> dict:
        """Summary of the chunks, index and channels."""
        out = {"chunks": self.n_chunks, "channels": {},
               "data_bytes": self.data_end - _FILE_HDR.size,
               "index_bytes": len(self.data) - self.data_end - _FOOTER.size,
               "snapshot_entries": int(self._cols["fill_in"].sum()),
               "snapshot_delta_entries": int(self._cols["snap_delta"].sum())}
        for c in self.channels:
            ks = self.chunks_of(c)
            hdr = self.header_of(int(ks[0]))
            out["channels"][c] = {
                "segments": len(ks),
                "blocks": self.total_blocks(c),
                "tail_samples": len(self.tail(c)),
                "mode": hdr.mode,
                "block_size": hdr.block_size,
                "num_dict": hdr.num_dict,
                "dtype": str(np.dtype(hdr.dtype)),
                "finished": not (self._cols["flags"][ks[-1]] & CHUNK_MORE),
            }
        return out
