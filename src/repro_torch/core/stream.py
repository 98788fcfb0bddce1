"""Byte-exact IDEALEM stream format (paper Sec. V, Figs. 8-11).

The encoder (``repro_torch.core.encoder``) emits fixed-shape per-block
decisions; this module assembles/parses the variable-length byte stream on the
host, preserving the paper's layout:

  std mode, D>=2 (Fig. 8):   miss: [idx u8][raw block 8B]   hit: [idx u8]
                             FIFO overwrite prefixes 0xFF (so D <= 255).
  std mode, D==1 (Fig. 9):   [raw block][hit-count bytes ...] repeated; a
                             count byte equal to max_count c means another
                             count byte follows (footnotes 7-8).
  res/delta, D>=2 (Fig.10):  miss: [idx][base f64][transformed (B-1)*8]
                             hit:  [idx][base f64]
  res/delta, D==1 (Fig.11):  [base][transformed]([count e][e bases])...

Misses are written verbatim (decoder reproduces them exactly); hits are
reconstructed by random permutation of the stored block (std mode) or by
re-anchoring the stored transformed values on the hit's base value
(res/delta mode; no permutation -- paper Sec. V-B2).

A fixed header (``_HDR``) + raw tail (samples not filling a block) precedes
the body.

Serialization is vectorized: block byte sizes, offsets and scatter indices
are computed with numpy cumsum/fancy-indexing instead of a per-block Python
loop; parsing walks only the 1-3 decision bytes per block in Python and
gathers all value payloads in one vectorized pass.  The byte layout is the
reference package's (``repro/core/stream.py``) byte for byte.

Append-mode framing: a stream may be a concatenation of
*segments*, each with its own header.  Non-final segments set FLAG_MORE;
segments continuing a previous segment's dictionary state set FLAG_CONT (the
decoder carries the FIFO fill counter across, and D==1 continuation segments
open with a hit-count run for the carried dictionary entry).  One-shot
streams are a single segment with neither flag -- byte-identical to the seed
format.  ``IdealemSession`` (repro_torch.core.session) emits these segments.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, replace
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from ..device import resolve_device
from ..errors import StreamFormatError
from . import decode as decode_mod
from .decode import MODE_DELTA, MODE_RESIDUAL, MODE_STD

__all__ = ["StreamHeader", "StreamFormatError", "assemble_stream",
           "parse_stream", "decode_stream", "segment_walk_count"]

# Per-segment decision walks since import.  Tests read deltas of it to show
# that the store's range decoder walks only the segments covering a range.
_stats = {"segment_walks": 0}


def segment_walk_count() -> int:
    return _stats["segment_walks"]

MAGIC = b"IDLM"
VERSION = 2
# Version 3 is emitted only when a v3-only feature (f16 payloads or the
# error-bounded no-permutation contract) is actually used, so v2 readers
# reject such streams with a typed StreamFormatError instead of decoding
# garbage, while every stream a v2 reader could decode stays byte-identical.
VERSION_EB = 3
FLAG_RANGE, FLAG_F32, FLAG_MORE, FLAG_CONT = 1, 2, 4, 8
FLAG_F16, FLAG_EB = 16, 32
_HDR = struct.Struct("<4sBBHBBBBddIH")  # 34 bytes (packed little-endian)


@dataclass
class StreamHeader:
    mode: int
    block_size: int
    num_dict: int
    max_count: int
    dtype: np.dtype
    value_range: Optional[Tuple[float, float]]
    n_blocks: int
    tail: np.ndarray
    more: bool = False  # another segment follows this one
    cont: bool = False  # continues the previous segment's dictionary state
    error_bounded: bool = False  # hits honored a pointwise bound; decode
    #                              skips the std-mode hit permutation

    @property
    def itemsize(self) -> int:
        return int(np.dtype(self.dtype).itemsize)


def _pack_header(h: StreamHeader) -> bytes:
    flags = 0
    rmin = rmax = 0.0
    if h.value_range is not None:
        flags |= FLAG_RANGE
        rmin, rmax = float(h.value_range[0]), float(h.value_range[1])
    if np.dtype(h.dtype) == np.float32:
        flags |= FLAG_F32
    elif np.dtype(h.dtype) == np.float16:
        flags |= FLAG_F16
    elif np.dtype(h.dtype) != np.float64:
        raise ValueError(f"unsupported dtype {h.dtype}")
    if h.more:
        flags |= FLAG_MORE
    if h.cont:
        flags |= FLAG_CONT
    if h.error_bounded:
        flags |= FLAG_EB
    ver = VERSION_EB if flags & (FLAG_F16 | FLAG_EB) else VERSION
    buf = _HDR.pack(
        MAGIC, ver, h.mode, h.block_size, h.num_dict, h.max_count,
        flags, 0, rmin, rmax, h.n_blocks, len(h.tail),
    )
    return buf + np.asarray(h.tail, dtype=h.dtype).tobytes()


def _unpack_header(buf: memoryview, off: int = 0) -> Tuple[StreamHeader, int]:
    hdr_off = off
    try:
        (magic, ver, mode, bsz, ndict, maxc, flags, _rsv, rmin, rmax,
         n_blocks, tail_len) = _HDR.unpack_from(buf, off)
    except struct.error:
        raise StreamFormatError("truncated segment header", hdr_off) from None
    if magic != MAGIC:
        raise StreamFormatError("bad IDEALEM stream magic", hdr_off)
    if ver not in (VERSION, VERSION_EB):
        raise StreamFormatError(f"unsupported stream version {ver}", hdr_off)
    if mode not in (MODE_STD, MODE_RESIDUAL, MODE_DELTA):
        raise StreamFormatError(f"unknown mode byte {mode}", hdr_off)
    if bsz < 2 or ndict < 1 or maxc < 1:
        raise StreamFormatError(
            f"degenerate header fields (B={bsz}, D={ndict}, c={maxc})",
            hdr_off)
    if ver == VERSION and flags & (FLAG_F16 | FLAG_EB):
        raise StreamFormatError("v3 feature flags on a version-2 segment",
                                hdr_off)
    if (flags & FLAG_F32) and (flags & FLAG_F16):
        raise StreamFormatError("both f32 and f16 dtype flags set", hdr_off)
    if flags & FLAG_F32:
        dtype = np.float32
    elif flags & FLAG_F16:
        dtype = np.float16
    else:
        dtype = np.float64
    off += _HDR.size
    if off + tail_len * np.dtype(dtype).itemsize > len(buf):
        raise StreamFormatError(
            f"tail of {tail_len} samples overruns the buffer", off)
    tail = np.frombuffer(buf, dtype=dtype, count=tail_len, offset=off).copy()
    off += tail_len * np.dtype(dtype).itemsize
    rng = (rmin, rmax) if (flags & FLAG_RANGE) else None
    hdr = StreamHeader(mode, bsz, ndict, maxc, np.dtype(dtype), rng,
                       n_blocks, tail,
                       more=bool(flags & FLAG_MORE),
                       cont=bool(flags & FLAG_CONT),
                       error_bounded=bool(flags & FLAG_EB))
    return hdr, off


def _excl_cumsum(sizes: np.ndarray) -> np.ndarray:
    offs = np.empty_like(sizes)
    offs[0] = 0
    np.cumsum(sizes[:-1], out=offs[1:])
    return offs


def _byte_rows(a: np.ndarray, dt: np.dtype) -> np.ndarray:
    """(n, k) values -> (n, k*itemsize) little-endian byte rows."""
    a = np.ascontiguousarray(a, dtype=dt)
    return a.view(np.uint8).reshape(len(a), a.shape[1] * dt.itemsize)


def _assemble_multi(mode, dt, raw_blocks, payload_blocks, bases,
                    is_hit, slot, ovw) -> bytes:
    """Vectorized D>=2 body: per-block sizes -> offsets -> scattered writes."""
    isz = dt.itemsize
    nb, B = raw_blocks.shape
    hit_sz = 1 + (0 if mode == MODE_STD else isz)
    # miss payload is B values in every mode (std: block; res/delta: base +
    # B-1 transformed), so a miss costs [0xFF?][idx][B*isz].
    sizes = np.where(is_hit, hit_sz, 1 + B * isz + ovw).astype(np.int64)
    offs = _excl_cumsum(sizes)
    out = np.zeros(int(sizes.sum()), dtype=np.uint8)

    out[offs[ovw]] = 0xFF
    idx_pos = offs + ovw  # overwrite prefix shifts the slot byte by one
    out[idx_pos] = slot.astype(np.uint8)
    val_pos = idx_pos + 1
    miss = ~is_hit
    if mode == MODE_STD:
        rows = _byte_rows(raw_blocks[miss], dt)
        out[val_pos[miss][:, None] + np.arange(B * isz)] = rows
    else:
        out[val_pos[:, None] + np.arange(isz)] = _byte_rows(
            np.asarray(bases)[:, None], dt)
        rows = _byte_rows(payload_blocks[miss], dt)
        out[(val_pos[miss] + isz)[:, None] + np.arange((B - 1) * isz)] = rows
    return out.tobytes()


class _RunLayout(NamedTuple):
    """Byte layout of a D==1 body (relative to body start): shared between
    the vectorized assembler and parser so the math cannot diverge."""

    miss_pos: np.ndarray   # (n_miss,) block index of each miss
    k: np.ndarray          # (n_runs,) hits per run
    has_miss: np.ndarray   # (n_runs,) False only for a cont leading run
    ncb: np.ndarray        # (n_runs,) count bytes per run
    offs: np.ndarray       # (n_runs,) run start offset
    hit_off: np.ndarray    # (n_runs,) start of the count/hit-base area
    total: int             # body size in bytes


def _single_layout(is_hit: np.ndarray, c: int, cont: bool, B: int, isz: int,
                   std: bool) -> _RunLayout:
    """Run-length layout for D==1 bodies (Figs. 9/11): k hits cost
    floor(k/c)+1 count bytes; res/delta interleaves c hit bases per count."""
    nb = len(is_hit)
    miss_pos = np.flatnonzero(~is_hit)
    n_miss = len(miss_pos)
    if not cont:
        assert n_miss and miss_pos[0] == 0, "first block of a run must be a miss"
    bounds = np.concatenate([miss_pos, [nb]]).astype(np.int64)
    k_miss = np.diff(bounds) - 1  # hits trailing each miss
    if cont:
        k0 = int(miss_pos[0]) if n_miss else nb
        k = np.concatenate([[k0], k_miss]).astype(np.int64)
        has_miss = np.concatenate([[False], np.ones(n_miss, bool)])
    else:
        k = k_miss
        has_miss = np.ones(n_miss, bool)
    ncb = k // c + 1
    hit_area = ncb if std else ncb + k * isz
    sizes = has_miss * (B * isz) + hit_area
    offs = _excl_cumsum(sizes)
    return _RunLayout(miss_pos, k, has_miss, ncb, offs,
                      offs + has_miss * (B * isz), int(sizes.sum()))


def _single_hit_base_offs(lay: _RunLayout, is_hit: np.ndarray, c: int,
                          isz: int, cont: bool) -> np.ndarray:
    """res/delta D==1: byte offset of every hit's base value, in hit order."""
    hit_pos = np.flatnonzero(is_hit)
    if not len(hit_pos):
        return np.zeros(0, dtype=np.int64)
    r = np.searchsorted(lay.miss_pos, hit_pos, side="right") - 1
    run_idx = r + 1 if cont else r
    first = (np.where(r >= 0, lay.miss_pos[np.clip(r, 0, None)] + 1, 0)
             if len(lay.miss_pos) else np.zeros(len(hit_pos), dtype=np.int64))
    h = hit_pos - first  # hit ordinal within its run
    return (lay.hit_off[run_idx] + (h // c) * (1 + c * isz) + 1
            + (h % c) * isz)


def _assemble_single(mode, dt, raw_blocks, payload_blocks, bases,
                     is_hit, c, cont) -> bytes:
    """Vectorized D==1 body: hit-count runs (Figs. 9/11) via run-length math.

    With ``cont`` the segment opens with a *headless* count-run for hits on
    the dictionary entry carried from the previous segment (possibly 0).
    """
    isz = dt.itemsize
    nb, B = raw_blocks.shape
    lay = _single_layout(is_hit, c, cont, B, isz, mode == MODE_STD)
    miss_pos, k, has_miss, ncb, offs, hit_off = (
        lay.miss_pos, lay.k, lay.has_miss, lay.ncb, lay.offs, lay.hit_off)
    n_miss, n_runs = len(miss_pos), len(k)
    out = np.zeros(lay.total, dtype=np.uint8)

    if n_miss:
        moffs = offs[has_miss]
        if mode == MODE_STD:
            out[moffs[:, None] + np.arange(B * isz)] = _byte_rows(
                raw_blocks[miss_pos], dt)
        else:
            out[moffs[:, None] + np.arange(isz)] = _byte_rows(
                np.asarray(bases)[miss_pos][:, None], dt)
            out[(moffs + isz)[:, None] + np.arange((B - 1) * isz)] = (
                _byte_rows(payload_blocks[miss_pos], dt))

    stride = 1 if mode == MODE_STD else 1 + c * isz
    total_cb = int(ncb.sum())
    cnt_val = np.full(total_cb, c, dtype=np.uint8)
    cnt_val[np.cumsum(ncb) - 1] = (k % c).astype(np.uint8)
    run_id = np.repeat(np.arange(n_runs), ncb)
    g = np.arange(total_cb) - np.repeat(np.cumsum(ncb) - ncb, ncb)
    out[hit_off[run_id] + g * stride] = cnt_val

    if mode != MODE_STD:
        tgt = _single_hit_base_offs(lay, is_hit, c, isz, cont)
        if len(tgt):
            out[tgt[:, None] + np.arange(isz)] = _byte_rows(
                np.asarray(bases)[is_hit][:, None], dt)
    return out.tobytes()


def assemble_stream(
    header: StreamHeader,
    raw_blocks: np.ndarray,      # (nb, B) original values
    payload_blocks: np.ndarray,  # (nb, B) std mode / (nb, B-1) res-delta
    bases: Optional[np.ndarray],  # (nb,) res/delta mode only
    is_hit: np.ndarray,
    slot: np.ndarray,
    overwrite: np.ndarray,
) -> bytes:
    """Serialize encoder decisions into the paper's byte format (one segment).

    Byte-identical to the reference package's ``assemble_stream``; all
    offset/scatter math is vectorized numpy.
    """
    dt = np.dtype(header.dtype)
    head = _pack_header(header)
    nb = len(raw_blocks)
    assert header.n_blocks == nb
    if nb == 0:
        return head
    is_hit = np.asarray(is_hit, dtype=bool)
    slot = np.asarray(slot, dtype=np.int64)
    overwrite = np.asarray(overwrite, dtype=bool)
    raw_blocks = np.asarray(raw_blocks)
    if header.num_dict >= 2:
        body = _assemble_multi(header.mode, dt, raw_blocks, payload_blocks,
                               bases, is_hit, slot, overwrite)
    else:
        body = _assemble_single(header.mode, dt, raw_blocks, payload_blocks,
                                bases, is_hit, header.max_count, header.cont)
    return head + body


# ------------------------------------------------------------------ parsing

class _Parsed(NamedTuple):
    is_hit: np.ndarray            # (nb,) bool
    slot: np.ndarray              # (nb,) int32
    overwrite: np.ndarray         # (nb,) bool
    bases: Optional[np.ndarray]   # (nb,) dt, res/delta modes only
    payloads: np.ndarray          # (n_miss, P) dt, in miss order


def _walk_segment(buf, off, header, fill, hits_b, slots_b, ovws_b):
    """Scalar walk over one segment's decision/count bytes.

    Appends one byte per block to the decision bytearrays (C-speed) and
    skips over value bytes; value offsets are NOT recorded here -- they are
    reconstructed vectorized from the decision arrays with the same layout
    math the assembler uses.  Returns (new_off, new_fill)."""
    _stats["segment_walks"] += 1
    try:
        return _walk_segment_inner(buf, off, header, fill, hits_b, slots_b,
                                   ovws_b)
    except IndexError:
        raise StreamFormatError("truncated segment body", off) from None


def _walk_segment_inner(buf, off, header, fill, hits_b, slots_b, ovws_b):
    isz = np.dtype(header.dtype).itemsize
    bsz = header.block_size
    std = header.mode == MODE_STD
    hit_val = 0 if std else isz                      # value bytes on a hit
    miss_val = (0 if std else isz) + (bsz if std else bsz - 1) * isz
    c = header.max_count

    if header.num_dict >= 2:
        nd = header.num_dict
        for _ in range(header.n_blocks):
            b = buf[off]
            off += 1
            if b == 0xFF:
                slots_b.append(buf[off])
                off += 1 + miss_val
                hits_b.append(0)
                ovws_b.append(1)
            elif b == fill and fill < nd:
                slots_b.append(b)
                off += miss_val
                hits_b.append(0)
                ovws_b.append(0)
                fill += 1
            else:
                slots_b.append(b)
                off += hit_val
                hits_b.append(1)
                ovws_b.append(0)
    else:
        n_left = header.n_blocks
        leading = header.cont  # run carried over the segment boundary
        while n_left > 0:
            if not leading:
                hits_b.append(0)
                slots_b.append(0)
                ovws_b.append(0)
                off += miss_val
                n_left -= 1
                fill = 1
            leading = False
            while True:  # one hit-count run
                e = buf[off]
                off += 1
                if e:
                    hits_b.extend(b"\x01" * e)
                    slots_b.extend(bytes(e))
                    ovws_b.extend(bytes(e))
                    off += e * hit_val
                    n_left -= e
                if e < c:
                    break
        if n_left < 0:
            raise StreamFormatError(
                "hit-count run overruns the segment block count", off)
    if off > len(buf):
        raise StreamFormatError(
            f"segment value bytes overrun the buffer by {off - len(buf)}",
            len(buf))
    return off, fill


class SegmentRef(NamedTuple):
    """One walked segment of a (possibly multi-segment) stream: where it
    lives in the buffer, which blocks it covers, and the FIFO fill counter
    entering it.  The store's container index persists exactly this, so a
    segment can later be walked again on its own."""

    header: StreamHeader
    start: int       # byte offset of the segment header
    body_start: int  # byte offset of the first decision byte
    end: int         # byte offset one past the segment body
    i0: int          # index of the segment's first block within the walk
    n_blocks: int
    fill_in: int     # FIFO fill counter entering the segment


def _walk_all(buf: memoryview, off: int = 0, fill: int = 0,
              till_end: bool = False):
    """Walk a chained (FLAG_MORE) sequence of segments starting at ``off``
    with FIFO fill counter ``fill``.

    Stops after the first non-MORE segment; with ``till_end`` it instead
    walks until the buffer is exhausted (a partial chain, e.g. the segments
    a live session has emitted so far, every one FLAG_MORE, which the
    store's container writer appends incrementally).

    Returns ``(segs, is_hit, slot, ovw)``: per-segment ``SegmentRef``s plus
    the concatenated per-block decision arrays."""
    hits_b = bytearray()
    slots_b = bytearray()
    ovws_b = bytearray()
    segs: List[SegmentRef] = []
    while True:
        start = off
        header, off = _unpack_header(buf, off)
        if segs and not header.cont:
            fill = 0  # restart segment: fresh dictionary state
        i0, body_start, fill_in = len(hits_b), off, fill
        off, fill = _walk_segment(buf, off, header, fill, hits_b, slots_b,
                                  ovws_b)
        segs.append(SegmentRef(header, start, body_start, off, i0,
                               len(hits_b) - i0, fill_in))
        if till_end:
            if off >= len(buf):
                break
        elif not header.more:
            break
    is_hit = np.frombuffer(hits_b, dtype=np.uint8).astype(bool)
    slot = np.frombuffer(slots_b, dtype=np.uint8).astype(np.int32)
    ovw = np.frombuffer(ovws_b, dtype=np.uint8).astype(bool)
    return segs, is_hit, slot, ovw


def _segment_offsets(header: StreamHeader, body_start: int, h: np.ndarray,
                     o: np.ndarray, cont: bool):
    """Absolute value-byte offsets for one walked segment, recomputed with
    the assembler's layout math from its decision arrays.

    Returns ``(base_offs, pay_offs)``: per-block base offsets (res/delta
    modes, else ``None``) and per-miss payload offsets in miss order."""
    dt = np.dtype(header.dtype)
    isz = dt.itemsize
    B = header.block_size
    std = header.mode == MODE_STD
    if header.num_dict >= 2:
        hit_sz = 1 + (0 if std else isz)
        sizes = np.where(h, hit_sz, 1 + B * isz + o).astype(np.int64)
        val = body_start + _excl_cumsum(sizes) + o + 1
        if std:
            return None, val[~h]
        return val, val[~h] + isz
    lay = _single_layout(h, header.max_count, cont, B, isz, std)
    moffs = body_start + lay.offs[lay.has_miss]
    if std:
        return None, moffs
    bo = np.empty(len(h), dtype=np.int64)
    bo[lay.miss_pos] = moffs
    bo[h] = body_start + _single_hit_base_offs(
        lay, h, header.max_count, isz, cont)
    return bo, moffs + isz


def _gather_values(u8: np.ndarray, dt: np.dtype, P: int, base_parts,
                   pay_parts):
    """One fancy-indexing pass over the raw bytes: per-block bases (or
    ``None`` for std mode) and the (n_miss, P) payload matrix."""
    if base_parts is None:
        bases = None
    else:
        bo = (np.concatenate(base_parts) if base_parts
              else np.zeros(0, dtype=np.int64))
        bases = decode_mod.gather_rows(u8, dt, bo, 1).ravel()
    po = (np.concatenate(pay_parts) if pay_parts
          else np.zeros(0, dtype=np.int64))
    return bases, decode_mod.gather_rows(u8, dt, po, P)


def _hdr_params(h: StreamHeader):
    """Decode-relevant header parameters (framing flags and counts excluded);
    segments whose params differ cannot share one merged plan."""
    return (h.mode, h.block_size, h.num_dict, h.max_count,
            np.dtype(h.dtype).str, h.value_range, h.error_bounded)


def _split_sections(segs: List[SegmentRef]) -> List[List[SegmentRef]]:
    """Group a walked segment chain into *restart sections*: maximal runs of
    segments whose dictionary state chains (every segment after the first
    has FLAG_CONT).  An adaptive session emits a new section per mode
    switch; plain sessions are a single section."""
    out: List[List[SegmentRef]] = []
    cur: List[SegmentRef] = []
    for seg in segs:
        if cur and not seg.header.cont:
            out.append(cur)
            cur = []
        cur.append(seg)
    out.append(cur)
    return out


def _section_arrays(u8, segs, is_hit, slot, ovw) -> Tuple[StreamHeader,
                                                          _Parsed]:
    """Merge a run of parameter-homogeneous segments (already walked) into
    struct-of-arrays form; value offsets are recomputed per segment with
    the assembler's layout math and gathered in one fancy-indexing pass."""
    for seg in segs[1:]:
        if _hdr_params(seg.header) != _hdr_params(segs[0].header):
            raise StreamFormatError(
                "segment parameters changed mid-stream; heterogeneous "
                "(adaptive) streams must be decoded with decode_stream",
                seg.start)
    i0 = segs[0].i0
    i1 = segs[-1].i0 + segs[-1].n_blocks
    merged = replace(segs[0].header, n_blocks=i1 - i0,
                     tail=segs[-1].header.tail, more=False, cont=False)
    std = merged.mode == MODE_STD
    P = merged.block_size if std else merged.block_size - 1

    base_parts = None if std else []  # per-block base offsets, block order
    pay_parts = []                    # per-miss payload offsets, miss order
    for seg in segs:
        if seg.n_blocks == 0:
            continue
        h = is_hit[seg.i0:seg.i0 + seg.n_blocks]
        o = ovw[seg.i0:seg.i0 + seg.n_blocks]
        bo, po = _segment_offsets(seg.header, seg.body_start, h, o,
                                  seg.header.cont)
        if bo is not None:
            base_parts.append(bo)
        pay_parts.append(po)

    bases, payloads = _gather_values(u8, np.dtype(merged.dtype), P,
                                     base_parts, pay_parts)
    return merged, _Parsed(is_hit[i0:i1], slot[i0:i1], ovw[i0:i1], bases,
                           payloads)


def _parse_arrays(data) -> Tuple[StreamHeader, _Parsed]:
    """Parse a (possibly multi-segment) stream into struct-of-arrays form.

    Per-block Python work is the decision-byte walk only.  Requires every
    segment to share decode parameters (raises :class:`StreamFormatError`
    for heterogeneous adaptive streams -- those decode section-by-section
    via :func:`decode_stream`); parameter-homogeneous restarts merge fine
    because a restarted dictionary's hits still source the most recent
    miss written to their slot."""
    buf = memoryview(data)
    u8 = np.frombuffer(buf, dtype=np.uint8)
    segs, is_hit, slot, ovw = _walk_all(buf)
    return _section_arrays(u8, segs, is_hit, slot, ovw)


def parse_stream(data):
    """Parse a stream into (header, events); each event is a dict with
    kind in {'miss','hit'} plus per-kind payload.  Multi-segment (session)
    streams are merged: the returned header carries the total block count
    and the final segment's tail."""
    header, pr = _parse_arrays(data)
    std = header.mode == MODE_STD
    hits_l = pr.is_hit.tolist()
    slots_l = pr.slot.tolist()
    ovw_l = pr.overwrite.tolist()
    bases_l = None if std else pr.bases.tolist()
    pay_rows = list(pr.payloads)  # row views into the gathered matrix
    events = []
    mi = 0
    for i, ih in enumerate(hits_l):
        if ih:
            ev = {"kind": "hit", "slot": slots_l[i]}
            if not std:
                ev["base"] = bases_l[i]
        else:
            ev = {"kind": "miss", "slot": slots_l[i], "overwrite": ovw_l[i]}
            if not std:
                ev["base"] = bases_l[i]
            ev["payload"] = pay_rows[mi]
            mi += 1
        events.append(ev)
    return header, events


def decode_stream(data: bytes, seed: int = 0, backend: str = "cuda",
                  device=None) -> np.ndarray:
    """Full decoder: parse -> ``DecodePlan`` -> ``decode.reconstruct``
    (paper Sec. V-A2/V-B2).

    Hits source the most recent miss written to their slot; std-mode hits
    are random permutations of that block, res/delta hits re-anchor the
    stored transformed values on the hit's own base.  ``backend`` selects
    the reconstruction backend (``decode.BACKENDS``) and ``device`` where
    the ``torch``/``cuda`` backends run (default: the card, raising
    without a GPU; ``backend="numpy"`` decodes on the host).  Every backend
    is byte-identical.

    Note: each hit's permutation is drawn statelessly from ``(seed, block
    position)`` (``decode.hit_perms``), so the sampled permutations differ
    from the seed decoder's sequential per-hit draws.  Any permutation is a
    valid reconstruction (the format pins bytes, not the decoder's RNG
    sequence); decode is deterministic for a fixed stream + seed.

    Heterogeneous (adaptive-session) streams -- segment parameters changing
    at a dictionary restart -- are decoded section by section with each
    section's own header parameters; the outputs (and each section's tail)
    concatenate in stream order.
    """
    if backend != "numpy":
        device = resolve_device(device)
    buf = memoryview(data)
    u8 = np.frombuffer(buf, dtype=np.uint8)
    segs, is_hit, slot, ovw = _walk_all(buf)
    dt0 = np.dtype(segs[0].header.dtype)
    outs = []
    for section in _split_sections(segs):
        header, pr = _section_arrays(u8, section, is_hit, slot, ovw)
        if np.dtype(header.dtype) != dt0:
            raise StreamFormatError("dtype changed across restart sections",
                                    section[0].start)
        if len(pr.is_hit):
            plan = decode_mod.plan_from_parsed(header, pr, seed=seed,
                                               i0=section[0].i0)
            outs.append(decode_mod.reconstruct(
                plan, backend=backend, device=device).ravel())
        if len(header.tail):
            outs.append(np.asarray(header.tail, dtype=dt0))
    if not outs:
        return np.zeros((0,), dtype=dt0)
    return np.concatenate(outs)
