"""Batched range decode over a packed container.

``decode_range(store, i, j)`` returns exactly
``decode_stream(channel_stream)[i*B : j*B]`` -- byte-identical -- while
touching only the segments that cover blocks ``[i, j)``:

  1. *seek*: the footer index's cumulative block counts locate the covering
     chunks (two ``searchsorted``\\ s, no byte walking);
  2. *parse*: only those chunks' decision bytes are walked (``parse_chunk``,
     cacheable through the ``parse=`` hook);  carried dictionary entries
     are materialized from the index's snapshot offsets as *virtual misses*
     in front of the window, so history is never replayed;
  3. *plan + reconstruct*: the requested blocks' payload rows are gathered
     in one fancy-indexing pass (``decode.gather_rows``) into per-request
     ``PlanPart``\\ s, padded into ONE ``DecodePlan`` and rebuilt by the
     decode engine (``repro_torch.core.decode.reconstruct``) on the
     selected backend: on a delta container with ``backend="cuda"`` that
     is one K2 launch for the whole batch.  Hit permutations are keyed on
     the global block position (``decode.hit_perms``), which is what makes
     the slice exact.

This module owns the *container-specific* plumbing only (seek, window
assembly, snapshot materialization, byte gather); all reconstruction math
lives in ``repro_torch.core.decode``.  ``plan_parts`` is the seam a serving
layer uses to merge parts from many containers into one dispatch.

Reads default to ``backend="cuda"`` on the card (``device`` default
``"cuda"``, raising without a GPU); ``backend="numpy"`` decodes on the
host, and the tensor backends run their plain versions on
``device="cpu"``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from ..core import decode as decode_mod
from ..core import stream as stream_mod
from ..core.decode import PlanPart
from ..core.stream import StreamHeader
from ..device import resolve_device
from ..errors import StreamFormatError

from .container import Container

# Read-path registry metrics.  Chunk walks count actual decision-byte
# walks: a parsed-chunk cache in front of parse_chunk keeps its hits out
# of it.
_M_WALKS = obs.registry().counter(
    "repro_store_chunk_walks_total",
    "container chunk decision-byte walks (cache misses reach here)")
# one observation a walk, and no span: a flush walks hundreds of chunks
_M_WALK_SECONDS = obs.registry().histogram(
    "repro_store_chunk_walk_seconds",
    "container chunk decision-byte walk wall time")
_M_RANGE_REQS = obs.registry().counter(
    "repro_store_range_requests_total",
    "range-decode requests (one per (channel, start, stop) tuple)")
_M_GATHER_BYTES = obs.registry().counter(
    "repro_store_gather_bytes_total",
    "payload/base bytes fancy-index-gathered from containers")
# request extents in blocks, pow-2-ish ladder: 1 block .. 64k blocks
_M_RANGE_BLOCKS = obs.registry().histogram(
    "repro_store_range_blocks",
    "requested range sizes in blocks",
    buckets=tuple(float(1 << p) for p in range(0, 17, 2)))

__all__ = [
    "ParsedChunk",
    "parse_chunk",
    "plan_windows",
    "gather_parts",
    "plan_parts",
    "decode_range",
    "decode_ranges",
    "decode_channels",
]


class ParsedChunk(NamedTuple):
    """One chunk's walked decisions + absolute value-byte offsets.

    Pure function of ``(container bytes, chunk id)`` -- safe to cache."""

    header: StreamHeader
    is_hit: np.ndarray             # (nb,) bool
    slot: np.ndarray               # (nb,) int32
    base_offs: Optional[np.ndarray]  # (nb,) abs offsets (res/delta) or None
    pay_offs: np.ndarray           # (n_miss,) abs payload offsets, miss order


def parse_chunk(store: Container, chunk: int) -> ParsedChunk:
    """Walk one chunk's decision bytes in isolation.

    The index supplies the two pieces of cross-segment state a raw stream
    only has implicitly: the FIFO fill counter entering the segment and
    (elsewhere, via ``Container.snapshot``) the dictionary contents."""
    _M_WALKS.inc()
    t0 = time.perf_counter()
    try:
        return _walk_chunk(store, chunk)
    finally:
        _M_WALK_SECONDS.observe(time.perf_counter() - t0)


def _walk_chunk(store: Container, chunk: int) -> ParsedChunk:
    buf = memoryview(store.data)
    start = int(store._cols["offset"][chunk])
    hdr, off = stream_mod._unpack_header(buf, start)
    fill_in = int(store._cols["fill_in"][chunk])
    hb, sb, ob = bytearray(), bytearray(), bytearray()
    end, _ = stream_mod._walk_segment(buf, off, hdr, fill_in, hb, sb, ob)
    if end != start + int(store._cols["length"][chunk]):
        raise StreamFormatError(
            f"chunk {chunk} walk ended at {end}, index says "
            f"{start + int(store._cols['length'][chunk])}", end)
    h = np.frombuffer(hb, np.uint8).astype(bool)
    s = np.frombuffer(sb, np.uint8).astype(np.int32)
    o = np.frombuffer(ob, np.uint8).astype(bool)
    if len(h):
        bo, po = stream_mod._segment_offsets(hdr, off, h, o, hdr.cont)
    else:
        bo = None if hdr.mode == stream_mod.MODE_STD else np.zeros(0, np.int64)
        po = np.zeros(0, np.int64)
    return ParsedChunk(hdr, h, s, bo, po)


ParseFn = Callable[[Container, int], ParsedChunk]


class _Window(NamedTuple):
    """Decision state of the chunks covering one block range, plus the
    snapshot-sourced virtual misses standing in for pre-window history."""

    header: StreamHeader
    gb0: int                  # global block index of the window's first block
    n_vir: int                # virtual (snapshot) misses prepended
    src_pay_offs: np.ndarray  # per-miss payload offsets (virtuals first)
    src: np.ndarray           # per-block source row, window-local, incl. virt
    is_hit: np.ndarray        # (window nb,) real blocks only
    base_offs: Optional[np.ndarray]


def _covering_chunks(store: Container, channel: int, start: int,
                     stop: int) -> Tuple[np.ndarray, int]:
    ks = store.chunks_of(channel)
    total = store.total_blocks(channel)
    if not (0 <= start < stop <= total):
        raise IndexError(
            f"block range [{start}, {stop}) outside [0, {total}) of "
            f"channel {channel}")
    ends = (store._cols["blocks_before"][ks]
            + store._cols["n_blocks"][ks])
    k0 = int(np.searchsorted(ends, start, side="right"))
    k1 = int(np.searchsorted(ends, stop, side="left"))
    return ks[k0:k1 + 1], int(store._cols["blocks_before"][ks[k0]])


def _parse_window(store: Container, chunks: np.ndarray, gb0: int,
                  parse: ParseFn) -> _Window:
    parts = [parse(store, int(k)) for k in chunks]
    hdr = parts[0].header
    fill0 = int(store._cols["fill_in"][chunks[0]])
    snap = store.snapshot(int(chunks[0]))
    h = np.concatenate([p.is_hit for p in parts])
    s = np.concatenate([p.slot for p in parts])
    pay = np.concatenate([p.pay_offs for p in parts])
    bo = (None if hdr.mode == stream_mod.MODE_STD
          else np.concatenate([p.base_offs for p in parts]))

    # Carried dictionary entries enter as virtual misses in front of the
    # window: slot k's live payload lives at snapshot offset k.  After this,
    # hit-source resolution is identical to the full decoder's.
    h_ext = np.concatenate([np.zeros(fill0, bool), h])
    s_ext = np.concatenate([np.arange(fill0, dtype=np.int32), s])
    src = decode_mod.decode_sources(h_ext, s_ext)
    return _Window(hdr, gb0, fill0, np.concatenate([snap, pay]), src, h, bo)


def plan_windows(store: Container, requests: Sequence[Tuple[int, int, int]],
                 parse: ParseFn = parse_chunk
                 ) -> Tuple[StreamHeader, List[_Window]]:
    """The *plan* stage of a batched range decode: seek + walk only.

    For many ``(channel, start, stop)`` requests, locate each request's
    covering chunks via the footer index and walk their decision bytes
    into ``_Window``\\ s (hit sources resolved, snapshot entries prepended
    as virtual misses).  No value bytes are touched yet -- that is
    :func:`gather_parts`, the stage a pipelined server may run later.
    Requests whose windows share a chunk walk it once (per-call memo).
    Heterogeneous codec parameters across requests raise: split such
    requests into separate calls."""
    memo: Dict[int, ParsedChunk] = {}

    def parse_once(st, k):
        if k not in memo:
            memo[k] = parse(st, k)
        return memo[k]

    windows = []
    for channel, start, stop in requests:
        chunks, gb0 = _covering_chunks(store, channel, start, stop)
        windows.append(_parse_window(store, chunks, gb0, parse_once))

    hdr = windows[0].header
    for w in windows[1:]:
        if ((w.header.mode, w.header.block_size, np.dtype(w.header.dtype),
             w.header.value_range)
                != (hdr.mode, hdr.block_size, np.dtype(hdr.dtype),
                    hdr.value_range)):
            raise ValueError(
                "batched ranges must share mode/block_size/dtype/value_range"
                "; split heterogeneous requests into separate decode_ranges "
                "calls")
    return hdr, windows


def gather_parts(store: Container, hdr: StreamHeader,
                 windows: Sequence[_Window],
                 requests: Sequence[Tuple[int, int, int]]) -> List[PlanPart]:
    """The *gather* stage: one shared fancy-index pass over the raw
    container bytes resolving every planned window's in-range payload
    (and base) offsets into source-resolved ``PlanPart``\\ s.  Each
    distinct payload row is read from the container once and then copied
    to every block it feeds."""
    dt = np.dtype(hdr.dtype)
    std = hdr.mode == stream_mod.MODE_STD
    P = hdr.block_size if std else hdr.block_size - 1
    u8 = np.frombuffer(store.data, dtype=np.uint8)

    # one shared gather: every request's in-range payload offsets (and
    # bases), concatenated, hit the raw bytes in a single fancy-index pass
    po_parts, bo_parts = [], []
    for w, (channel, start, stop) in zip(windows, requests):
        lo = start - w.gb0
        sl = slice(lo + w.n_vir, stop - w.gb0 + w.n_vir)
        po_parts.append(w.src_pay_offs[w.src[sl]])
        if not std:
            bo_parts.append(w.base_offs[lo:stop - w.gb0])
    # hits share their source's row: read each distinct row once
    uniq, inv = np.unique(np.concatenate(po_parts), return_inverse=True)
    rows_flat = decode_mod.gather_rows(u8, dt, uniq, P)[inv]
    bases_flat = (None if std else decode_mod.gather_rows(
        u8, dt, np.concatenate(bo_parts), 1).ravel())
    _M_GATHER_BYTES.inc(rows_flat.nbytes
                        + (0 if bases_flat is None else bases_flat.nbytes))

    parts, pos = [], 0
    for w, (channel, start, stop) in zip(windows, requests):
        n = stop - start
        parts.append(PlanPart(
            rows=rows_flat[pos:pos + n],
            bases=None if std else bases_flat[pos:pos + n],
            is_hit=w.is_hit[start - w.gb0:start - w.gb0 + n],
            block_idx=np.arange(start, stop, dtype=np.int64)))
        pos += n
    return parts


def plan_parts(store: Container, requests: Sequence[Tuple[int, int, int]],
               parse: ParseFn = parse_chunk
               ) -> Tuple[StreamHeader, List[PlanPart]]:
    """Seek + parse + gather for many ``(channel, start, stop)`` requests:
    :func:`plan_windows` followed by :func:`gather_parts`.  Returns the
    (shared) stream header and one source-resolved ``PlanPart`` per
    request."""
    hdr, windows = plan_windows(store, requests, parse=parse)
    return hdr, gather_parts(store, hdr, windows, requests)


def decode_range(store: Container, start_block: int, stop_block: int,
                 channel: int = 0, seed: int = 0,
                 parse: ParseFn = parse_chunk,
                 backend: str = "cuda", device=None) -> np.ndarray:
    """Decode blocks ``[start_block, stop_block)`` of one channel.

    Byte-identical to the same slice of a full ``decode_stream`` over the
    channel's reassembled stream (on every backend); work is proportional
    to the requested range (only covering segments are walked, as
    ``segment_walk_count`` shows)."""
    return decode_ranges(store, [(channel, start_block, stop_block)],
                         seed=seed, parse=parse, backend=backend,
                         device=device)[0]


def decode_ranges(store: Container, requests: Sequence[Tuple[int, int, int]],
                  seed: int = 0, parse: ParseFn = parse_chunk,
                  backend: str = "cuda", device=None) -> List[np.ndarray]:
    """Batched range decode: ``requests`` is ``[(channel, start, stop), ...]``.

    All requests share one payload gather and ONE reconstruct dispatch:
    ``plan_parts`` resolves each request to a ``PlanPart``,
    ``decode.pad_parts`` stacks them on a leading request axis padded to
    the longest request, and ``decode.reconstruct`` rebuilds everything on
    the chosen backend (``device`` as for ``reconstruct``: the card by
    default, raising without a GPU before any host work).  Returns one 1-D
    array per request, in request order."""
    if backend != "numpy":
        device = resolve_device(device)
    if not len(requests):
        return []
    _M_RANGE_REQS.inc(len(requests))
    for _, start, stop in requests:
        _M_RANGE_BLOCKS.observe(stop - start)
    hdr, parts = plan_parts(store, requests, parse=parse)
    plan, nbm = decode_mod.pad_parts(
        hdr.mode, hdr.block_size, hdr.dtype, hdr.value_range, parts,
        seed=seed, no_perm=bool(getattr(hdr, "error_bounded", False)))
    out = decode_mod.reconstruct(plan, backend=backend,
                                 device=device).reshape(
        len(parts), nbm, hdr.block_size)
    return [out[r, :len(p.is_hit)].ravel() for r, p in enumerate(parts)]


def decode_channels(store: Container, channels: Optional[Sequence[int]] = None,
                    seed: int = 0, parse: ParseFn = parse_chunk,
                    backend: str = "cuda", device=None
                    ) -> Dict[int, np.ndarray]:
    """Full decode of the selected channels (default: all), tails included,
    through one batched ``decode_ranges`` call.  Equals ``decode_stream``
    over each channel's reassembled stream."""
    if channels is None:
        channels = store.channels
    requests, blank = [], {}
    for c in channels:
        nb = store.total_blocks(c)
        if nb:
            requests.append((c, 0, nb))
        else:
            blank[c] = np.zeros(0, dtype=store.header_of(
                int(store.chunks_of(c)[0])).dtype)
    bodies = decode_ranges(store, requests, seed=seed, parse=parse,
                           backend=backend, device=device)
    out = dict(blank)
    for (c, _, _), body in zip(requests, bodies):
        out[c] = body
    return {c: np.concatenate([out[c], store.tail(c)]) for c in channels}
