"""Plain NumPy IDEALEM codec: the benchmark's reference encoder, stream
writer and window decoder.

Frozen from the port's host reference (``src/repro_torch/core/npref.py``,
``core/stream.py``'s byte layout, ``core/decode.py``'s per-block math and
``core/ks.py:critical_distance``) and checked against the paper
(arXiv:1911.06980, Secs. III-V, Figs. 8-11).  It imports numpy and the
standard library only: nothing of the program under test.

Decisions follow the arithmetic the program states for its scan: the
scan sees float32 casts of the payloads; the min/max gate (eq. 3) rounds
each difference and product in float32; the KS distance (eq. 1) is the
largest float32 ECDF gap, held against ``float32(d_crit)``.  The walk is
npref's: the lowest dictionary slot that passes both gates is the hit,
else the block is a miss inserted at ``count % D``.

``dtype`` is the precision the codec works in: the configurations state
float64; the control runs the same code in float32.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Codec", "Session", "critical_distance", "encode", "decide",
           "transform", "sources", "reconstruct", "hit_perms"]

MODES = {"std": 0, "residual": 1, "delta": 2}
MAGIC = b"IDLM"
VERSION, VERSION_EB = 2, 3
FLAG_RANGE, FLAG_F32, FLAG_MORE, FLAG_CONT, FLAG_F16 = 1, 2, 4, 8, 16
_HDR = struct.Struct("<4sBBHBBBBddIH")
_SERIES_TERMS = 40
_SMALL_LAM = 0.1


def critical_distance(alpha: float, n1: int, n2: int) -> float:
    """Largest KS distance whose asymptotic p-value is still >= alpha
    (bisection over the Kolmogorov series)."""
    en = (n1 * n2) / (n1 + n2)

    def q(lam: float) -> float:
        if lam < _SMALL_LAM:
            return 1.0
        j = np.arange(1, _SERIES_TERMS + 1)
        val = 2.0 * np.sum((-1.0) ** (j - 1) * np.exp(-2.0 * j * j * lam * lam))
        return float(np.clip(val, 0.0, 1.0))

    lo, hi = 1e-9, 10.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if q(mid) >= alpha:
            lo = mid
        else:
            hi = mid
    return lo / np.sqrt(en)


class Codec:
    """One configuration's codec parameters (the configuration file's
    ``mode``, ``block_size``, ``num_dict``, ``alpha``, ``rel_tol``,
    ``max_count`` and ``value_range``) at a working precision."""

    def __init__(self, cfg: dict, dtype=np.float64):
        self.mode = cfg["mode"]
        self.mode_id = MODES[self.mode]
        self.B = int(cfg["block_size"])
        self.D = int(cfg["num_dict"])
        self.rel_tol = float(cfg["rel_tol"])
        self.max_count = int(cfg.get("max_count", 255))
        vr = cfg.get("value_range")
        self.value_range = None if vr is None else (float(vr[0]), float(vr[1]))
        self.dtype = np.dtype(dtype)
        self.n = self.B if self.mode == "std" else self.B - 1
        self.d_crit = critical_distance(float(cfg["alpha"]), self.n, self.n)


def wrap_centered(v, rmin, rmax):
    w = rmax - rmin
    return np.mod(v + 0.5 * w, w) - 0.5 * w


def wrap_range(v, rmin, rmax):
    w = rmax - rmin
    return np.mod(v - rmin, w) + rmin


def transform(codec: Codec, blocks: np.ndarray):
    """Blocks (nb, B) -> (payload, bases): std keeps the block; residual
    and delta keep each block's first sample as its base and the B-1
    residuals or first differences, wrapped into the range when it has
    one (Sec. IV-A)."""
    if codec.mode == "std":
        return blocks, None
    bases = blocks[:, 0].copy()
    if codec.mode == "residual":
        t = blocks[:, 1:] - bases[:, None]
    else:
        t = np.diff(blocks, axis=1)
    if codec.value_range is not None:
        t = wrap_centered(t, *codec.value_range)
    return t, bases


class Dictionary:
    """The FIFO dictionary of one stream, resumable across calls."""

    def __init__(self, codec: Codec):
        D, n = codec.D, codec.n
        f32 = np.float32
        self.codec = codec
        self.rows = np.zeros((D, n), dtype=f32)     # sorted stored blocks
        self.lo_min = np.zeros(D, dtype=f32)
        self.hi_min = np.zeros(D, dtype=f32)
        self.lo_max = np.zeros(D, dtype=f32)
        self.hi_max = np.zeros(D, dtype=f32)
        self.valid = np.zeros(D, dtype=bool)
        self.count = 0
        self.r = f32(codec.rel_tol)
        self.nf = f32(n)
        self.pos = np.arange(1, n + 1, dtype=f32) / self.nf
        self.d_crit = f32(codec.d_crit)

    def _ks_ok(self, xs: np.ndarray, row: np.ndarray) -> bool:
        nf, pos = self.nf, self.pos
        d1 = np.abs(pos - np.searchsorted(row, xs, "right").astype(
            np.float32) / nf).max()
        d2 = np.abs(np.searchsorted(xs, row, "right").astype(
            np.float32) / nf - pos).max()
        return max(d1, d2) <= self.d_crit

    def decide(self, payload: np.ndarray):
        """Decision triple ``(is_hit, slot, overwrite)`` of payload blocks
        (nb, n), continuing from (and updating) this dictionary."""
        D = self.codec.D
        xs_all = np.sort(np.asarray(payload).astype(np.float32), axis=1)
        nb = len(xs_all)
        is_hit = np.zeros(nb, dtype=bool)
        slot = np.zeros(nb, dtype=np.int32)
        ovw = np.zeros(nb, dtype=bool)
        for i in range(nb):
            xs = xs_all[i]
            xmin, xmax = xs[0], xs[-1]
            ok = (self.valid & (xmin >= self.lo_min) & (xmin <= self.hi_min)
                  & (xmax >= self.lo_max) & (xmax <= self.hi_max))
            hit = -1
            for s in np.flatnonzero(ok):
                if self._ks_ok(xs, self.rows[s]):
                    hit = int(s)
                    break
            if hit >= 0:
                is_hit[i], slot[i] = True, hit
                continue
            s = self.count % D
            ovw[i] = self.count >= D
            slot[i] = s
            self.rows[s] = xs
            t = (xmax - xmin) * self.r
            self.lo_min[s], self.hi_min[s] = xmin - t, xmin + t
            self.lo_max[s], self.hi_max[s] = xmax - t, xmax + t
            self.valid[s] = True
            self.count += 1
        return is_hit, slot, ovw


def decide(codec: Codec, payload: np.ndarray):
    """One-shot decisions from an empty dictionary."""
    return Dictionary(codec).decide(payload)


# ------------------------------------------------------------------ stream

def _header(codec: Codec, n_blocks: int, tail: np.ndarray, more: bool,
            cont: bool) -> bytes:
    flags = 0
    rmin = rmax = 0.0
    if codec.value_range is not None:
        flags |= FLAG_RANGE
        rmin, rmax = codec.value_range
    if codec.dtype == np.float32:
        flags |= FLAG_F32
    elif codec.dtype == np.float16:
        flags |= FLAG_F16
    if more:
        flags |= FLAG_MORE
    if cont:
        flags |= FLAG_CONT
    ver = VERSION_EB if flags & FLAG_F16 else VERSION
    head = _HDR.pack(MAGIC, ver, codec.mode_id, codec.B, codec.D,
                     codec.max_count, flags, 0, rmin, rmax, n_blocks,
                     len(tail))
    return head + np.asarray(tail, dtype=codec.dtype).tobytes()


def _count_run(out: bytearray, codec: Codec, bases) -> None:
    """The hits on a D == 1 entry (their ``bases``): count bytes, a byte
    equal to max_count meaning another follows (Figs. 9, 11); residual and
    delta put each count's hit bases after it."""
    c, k, done = codec.max_count, len(bases), 0
    while True:
        e = min(k - done, c)
        out.append(e)
        if codec.mode != "std":
            for b in bases[done:done + e]:
                out += np.asarray(b, dtype=codec.dtype).tobytes()
        done += e
        if e < c:
            break


def assemble(codec: Codec, raw: np.ndarray, payload: np.ndarray, bases,
             is_hit, slot, ovw, tail, more: bool, cont: bool) -> bytes:
    """One segment: header, raw tail, then a block at a time (Figs. 8-11)."""
    dt = codec.dtype
    out = bytearray(_header(codec, len(raw), tail, more, cont))
    std = codec.mode == "std"

    def miss_values(i):
        if std:
            return np.ascontiguousarray(raw[i], dtype=dt).tobytes()
        return (np.asarray(bases[i], dtype=dt).tobytes()
                + np.ascontiguousarray(payload[i], dtype=dt).tobytes())

    if codec.D >= 2:
        for i in range(len(raw)):
            if is_hit[i]:
                out.append(int(slot[i]))
                if not std:
                    out += np.asarray(bases[i], dtype=dt).tobytes()
                continue
            if ovw[i]:
                out.append(0xFF)
            out.append(int(slot[i]))
            out += miss_values(i)
        return bytes(out)
    i, nb = 0, len(raw)
    if cont:  # hits on the entry carried from the previous segment
        j = i
        while j < nb and is_hit[j]:
            j += 1
        _count_run(out, codec, raw[i:j, 0] if std else bases[i:j])
        i = j
    while i < nb:
        out += miss_values(i)
        j = i + 1
        while j < nb and is_hit[j]:
            j += 1
        _count_run(out, codec,
                   raw[i + 1:j, 0] if std else bases[i + 1:j])
        i = j
    return bytes(out)


def encode(cfg: dict, x: np.ndarray, dtype=None) -> bytes:
    """One-shot stream of ``x``: one segment with neither framing flag."""
    codec = Codec(cfg, x.dtype if dtype is None else dtype)
    x = np.asarray(x, dtype=codec.dtype)
    nb = len(x) // codec.B
    blocks = x[:nb * codec.B].reshape(nb, codec.B)
    payload, bases = transform(codec, blocks)
    h, s, o = decide(codec, payload)
    return assemble(codec, blocks, payload, bases, h, s, o, x[nb * codec.B:],
                    more=False, cont=False)


class Session:
    """A streaming encode of one stream: ``feed`` returns the append-mode
    segment of the whole blocks completed so far (``b""`` when none
    completed), ``finish`` the final segment carrying the tail."""

    def __init__(self, cfg: dict, dtype=np.float64):
        self.codec = Codec(cfg, dtype)
        self.dict = Dictionary(self.codec)
        self.tail = np.zeros(0, dtype=self.codec.dtype)
        self.started = False

    def feed(self, chunk) -> bytes:
        c = self.codec
        joined = np.concatenate([self.tail, np.asarray(chunk, dtype=c.dtype)])
        nb = len(joined) // c.B
        self.tail = joined[nb * c.B:]
        if nb == 0:
            return b""
        blocks = joined[:nb * c.B].reshape(nb, c.B)
        payload, bases = transform(c, blocks)
        h, s, o = self.dict.decide(payload)
        seg = assemble(c, blocks, payload, bases, h, s, o,
                       np.zeros(0, dtype=c.dtype), more=True,
                       cont=self.started)
        self.started = True
        return seg

    def finish(self) -> bytes:
        c = self.codec
        return _header(c, 0, self.tail, more=False, cont=self.started)


# ------------------------------------------------------------------ decode

def _splitmix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def hit_perms(seed: int, block_idx: np.ndarray, B: int) -> np.ndarray:
    """The std-mode hit permutation of each block position: the stable
    argsort of SplitMix64 keys of (seed, global sample index)."""
    with np.errstate(over="ignore"):
        s = _splitmix64(np.uint64(seed & 0xFFFFFFFFFFFFFFFF) + np.uint64(1))
        samp = (np.asarray(block_idx, dtype=np.uint64)[:, None] * np.uint64(B)
                + np.arange(B, dtype=np.uint64)[None, :])
    return np.argsort(_splitmix64(samp ^ s), axis=1, kind="stable")


def sources(is_hit: np.ndarray, slot: np.ndarray) -> np.ndarray:
    """The block whose stored values feed each block: a miss feeds
    itself, a hit the latest miss written to its slot."""
    src = np.arange(len(is_hit), dtype=np.int64)
    last: Dict[int, int] = {}
    for i in range(len(is_hit)):
        s = int(slot[i])
        if is_hit[i]:
            src[i] = last[s]
        else:
            last[s] = i
    return src


class Channel:
    """A channel's samples encoded from its start, as far as asked, for
    window reads: blocks, payloads, bases and decisions."""

    def __init__(self, cfg: dict, x: np.ndarray, dtype=np.float64):
        self.codec = Codec(cfg, dtype)
        self.x = np.asarray(x)
        self.dict = Dictionary(self.codec)
        self.done = 0
        self.parts: List[Tuple[np.ndarray, ...]] = []
        self._cat: Optional[Tuple[np.ndarray, ...]] = None

    def upto(self, nb: int):
        """Encode through block ``nb``; returns (blocks, payload, bases,
        is_hit, slot) of every block encoded so far."""
        c = self.codec
        if nb > self.done:
            x = self.x[self.done * c.B:nb * c.B].astype(c.dtype)
            blocks = x.reshape(-1, c.B)
            payload, bases = transform(c, blocks)
            h, s, _ = self.dict.decide(payload)
            self.parts.append((blocks, payload, bases, h, s))
            self.done = nb
            self._cat = None
        if self._cat is None:
            cols = list(zip(*self.parts))
            self._cat = tuple(None if col[0] is None else np.concatenate(col)
                              for col in cols)
        return self._cat


def reconstruct(channel: Channel, start: int, stop: int,
                seed: int) -> np.ndarray:
    """Samples of blocks ``[start, stop)`` as the decoder rebuilds them
    (Sec. V-A2/V-B2): a miss is its stored values, a std hit its source's
    values permuted by :func:`hit_perms`, a residual or delta hit its own
    base re-anchoring its source's stored transform (delta: a left-to-right
    cumsum), wrapped into the range when there is one."""
    c = channel.codec
    blocks, payload, bases, is_hit, slot = channel.upto(stop)
    src = sources(is_hit, slot)[start:stop]
    hit = is_hit[start:stop]
    if c.mode == "std":
        out = blocks[src].copy()
        pos = np.flatnonzero(hit)
        if len(pos):
            perm = hit_perms(seed, start + pos, c.B)
            out[pos] = np.take_along_axis(out[pos], perm, axis=1)
        return out.ravel()
    rows = payload[src]
    base = bases[start:stop][:, None]
    t = rows if c.mode == "residual" else np.cumsum(rows, axis=1)
    out = np.concatenate([base, base + t], axis=1)
    if c.value_range is not None:
        out = wrap_range(out, *c.value_range)
    return out.ravel()
