"""Fleet ingest (traffic ``kind`` ``"ingest"``): many live streams fed
through one ``StreamCoalescer``, a closed loop from one thread.

Parameters (the traffic file): ``streams`` live at once, each fed a
chunk of ``chunk_samples`` a round, in lock-step (synchrophasors report
on the same instants), the policy ``FlushPolicy(max_batch_streams,
max_batch_blocks)`` and the coalescer's ``capacity`` and
``block_bucket``.  A stream lives ``stream_life_samples`` samples, a
whole number of chunks; then it closes and a new stream id opens in its
slot, reading the next row of a ``pool_rows`` x life table made from the
seed.  The first streams start a seeded whole number of chunks into their
life, so streams close and open every round.  ``warm_rounds`` rounds run
in set-up; the window runs whole rounds until ``--seconds`` have passed
(a round ends when its flush has returned; a flush that the policy did
not trip is cut at the round's end).

The check: after the window every stream closes, and ``check_streams``
streams drawn from the seed are encoded again by the plain reference
from their samples, fed in the runs the flushes took; their bytes must
equal what the coalescer returned.
"""
from __future__ import annotations

import math
import sys
import time
from typing import Dict, List

import numpy as np

from . import kwork, signals
from .core import Check, Readings
from .env import HostWatch, steadiness

__all__ = ["run"]


class _Stream:
    __slots__ = ("row", "start", "pos", "blocks", "cuts", "segs")

    def __init__(self, row: int, start: int):
        self.row, self.start, self.pos = row, start, start
        self.blocks = 0        # whole blocks whose segments came back
        self.cuts: List[int] = []   # pos at each flush that took samples
        self.segs: List[bytes] = []


class Fleet:
    """The fleet's streams, their chunks and what came back."""

    def __init__(self, co, pool: np.ndarray, p: dict, B: int, seed: int):
        self.co, self.pool, self.B = co, pool, B
        self.rng = np.random.default_rng([seed, 0])
        self.chunk = int(p["chunk_samples"])
        self.life = int(p["stream_life_samples"])
        if self.life % self.chunk:
            raise ValueError("stream_life_samples is not a whole number "
                             "of chunk_samples")
        self.rows = len(pool)
        self.streams: Dict[str, _Stream] = {}
        self.opened = 0
        self.live: List[str] = []
        self.staged: List[str] = []
        self.attempted = self.failed = 0
        starts = self.chunk * self.rng.integers(
            0, self.life // self.chunk, int(p["streams"]))
        for s in starts:
            self.live.append(self._open(int(s)))

    def _open(self, start: int) -> str:
        sid = f"s{self.opened}"
        self.streams[sid] = _Stream(self.opened % self.rows, start)
        self.opened += 1
        self.co.open_stream(sid)
        return sid

    def _collect(self, res: Dict[str, bytes]) -> int:
        """Settle a flush: every stream it took samples from has its cut
        recorded, and one that completed a block must have a segment.
        Returns the f64 bytes of the samples it took."""
        nbytes = 0
        for sid in self.staged:
            st = self.streams[sid]
            fed = st.pos - (st.cuts[-1] if st.cuts else st.start)
            nbytes += 8 * fed
            st.cuts.append(st.pos)
            blocks = (st.pos - st.start) // self.B
            seg = res.get(sid)
            if seg is not None:
                st.segs.append(seg)
            elif blocks > st.blocks:
                self.failed += 1
            st.blocks = blocks
        self.staged = []
        return nbytes

    def round(self) -> int:
        """Each live stream submits its next chunk (a stream at the end of
        its life closes first and a new one takes its slot); returns the
        f64 bytes whose segments came back."""
        co, nbytes, flushed = self.co, 0, False
        for i, sid in enumerate(self.live):
            st = self.streams[sid]
            if st.pos >= self.life:
                st.segs.append(co.close_stream(sid))
                sid = self.live[i] = self._open(0)
                st = self.streams[sid]
            chunk = self.pool[st.row, st.pos:st.pos + self.chunk]
            st.pos += self.chunk
            self.staged.append(sid)
            self.attempted += 1
            res = co.submit(sid, chunk)
            if res is not None:
                nbytes += self._collect(res)
                flushed = True
        if not flushed:
            nbytes += self._collect(co.flush())
        return nbytes

    def close_all(self) -> None:
        for sid in self.live:
            self.streams[sid].segs.append(self.co.close_stream(sid))
        self.live = []


def _differing(a: bytes, b: bytes) -> int:
    m = min(len(a), len(b))
    x = np.frombuffer(a[:m], dtype=np.uint8)
    y = np.frombuffer(b[:m], dtype=np.uint8)
    return int(np.count_nonzero(x != y)) + abs(len(a) - len(b))


def _encode(ref, cfg: dict, row: np.ndarray, start: int, cuts, dtype):
    sess = ref.Session(cfg, dtype=dtype)
    out, prev = [], start
    for cut in cuts:
        out.append(sess.feed(row[prev:cut]))
        prev = cut
    out.append(sess.finish())
    return b"".join(out)


def check(fleet: Fleet, cfg: dict, p: dict, seed: int, ref,
          control=None) -> List[Check]:
    """Encode ``check_streams`` streams drawn from the seed again with the
    reference (``ref``: ``bench/reference/idealem_np.py``) and count the
    bytes that differ from the coalescer's; with ``control`` (a dtype),
    from the reference's own encode in that precision instead."""
    rng = np.random.default_rng([seed, 1])
    ids = sorted(fleet.streams)
    pick = rng.choice(len(ids), size=min(int(p["check_streams"]), len(ids)),
                      replace=False)
    diff = 0
    for k in sorted(int(i) for i in pick):
        st = fleet.streams[ids[k]]
        row = fleet.pool[st.row]
        want = _encode(ref, cfg, row, st.start, st.cuts, np.float64)
        got = (b"".join(st.segs) if control is None
               else _encode(ref, cfg, row, st.start, st.cuts, control))
        diff += _differing(got, want)
    return [Check("stream_bytes_differing", diff, 0),
            Check("segments_missing", fleet.failed, 0)]


class _K1Capture:
    """In a traced window (``on``): each K1 launch's inputs, for its work.
    Keeps the sorted blocks' extremes, the step mask, the decisions and
    the carry entering the launch, copied on the device into an arena of
    ``slots`` launches reserved at the first launch (twice its size a
    slot), so that the window allocates nothing for them after it; a
    launch that does not fit is copied into fresh memory and counted
    (``spilled``).  Its cost is kept: the host seconds of the copies'
    launches (``host_s``, taken out of ``decide_share``) and the bytes
    copied."""

    _ALIGN = 256

    def __init__(self, torch, on: bool, slots: int):
        from repro_torch.kernels import encode_step
        self.mod, self.real, self.launches = encode_step, None, []
        self.torch, self.on, self.slots = torch, on, int(slots)
        self.host_s, self.copied, self.spilled = 0.0, 0, 0
        self.arena, self.slot_bytes = None, 0

    def _size(self, t) -> int:
        n = t.numel() * t.element_size()
        return -(-n // self._ALIGN) * self._ALIGN

    def _keep(self, parts):
        need = sum(self._size(t) for t in parts)
        if self.arena is None:
            self.slot_bytes = 2 * need
            self.arena = self.torch.empty(self.slots * self.slot_bytes,
                                          dtype=self.torch.uint8,
                                          device=parts[0].device)
        used = len(self.launches) - self.spilled
        if need > self.slot_bytes or used >= self.slots:
            self.spilled += 1
            return tuple(t.clone() for t in parts)
        off, kept = used * self.slot_bytes, []
        for t in parts:
            n = t.numel() * t.element_size()
            v = self.arena[off:off + n].view(t.dtype).view(t.shape)
            v.copy_(t)
            kept.append(v)
            off += self._size(t)
        return tuple(kept)

    def __enter__(self):
        if not self.on:
            return self
        real = self.real = self.mod.encode_scan

        def spy(xs, valid, state, **kw):
            out, new_state = real(xs, valid, state, **kw)
            t0 = time.perf_counter()
            parts = (xs[..., 0], xs[..., -1], valid, out[0], state.dmin,
                     state.dmax, state.valid, state.count)
            kept = self._keep(parts)
            self.host_s += time.perf_counter() - t0
            self.copied += sum(t.numel() * t.element_size() for t in kept)
            self.launches.append(kept + (kw["rel_tol"],))
            return out, new_state

        self.mod.encode_scan = spy
        return self

    def __exit__(self, *exc):
        if self.on:
            self.mod.encode_scan = self.real
        return False

    def work(self, n: int) -> dict:
        nbytes = ops = 0
        for (xmin, xmax, valid, hit, dmin, dmax, dvalid, count,
             rel_tol) in self.launches:
            b, o = kwork.k1_flush_work(self.torch, xmin, xmax, valid, hit,
                                       dmin, dmax, dvalid, count, rel_tol, n)
            nbytes += b
            ops += o
        return {"bytes": nbytes, "ops": ops, "launches": len(self.launches),
                "capture_bytes": self.copied, "capture_host_s": self.host_s,
                "capture_spilled": self.spilled}


def run(env) -> dict:
    """Set up, warm, measure and check one ingest cell (see the module
    docstring); ``env`` is ``harness.env.Env``."""
    torch, dev, p, cfg = env.torch, env.device, env.traffic, env.config
    from repro_torch.core.session import IdealemSession
    from repro_torch.serve import FlushPolicy, StreamCoalescer

    codec_kw = env.codec_kwargs()
    B = int(cfg["block_size"])
    pool = signals.make_table(torch, cfg["signal"], int(p["pool_rows"]),
                              int(p["stream_life_samples"]), env.seed, dev)
    co = StreamCoalescer(
        policy=FlushPolicy(max_batch_streams=int(p["max_batch_streams"]),
                           max_batch_blocks=int(p["max_batch_blocks"])),
        capacity=int(p["capacity"]), block_bucket=int(p["block_bucket"]),
        backend="cuda", device=str(dev), **codec_kw)
    fleet = Fleet(co, pool, p, B, env.seed)
    warm = []
    for _ in range(int(p["warm_rounds"])):
        a = time.perf_counter()
        fleet.round()
        warm.append(time.perf_counter() - a)
    env.sync()
    setup_s = time.perf_counter() - env.t_start

    tr = env.tracer(spans=("encode.flush",),
                    timed=(("session.prepare", IdealemSession, "prepare"),
                           ("session.commit", IdealemSession, "commit")))
    k1 = _K1Capture(torch, env.trace,
                    slots=2 * math.ceil(env.seconds / min(warm)) + 8)
    attempted0, failed0 = fleet.attempted, fleet.failed
    flushes = []
    with tr, k1, HostWatch() as host:
        t0 = now = time.perf_counter()
        while now - t0 < env.seconds:
            a = now
            nbytes = fleet.round()
            now = time.perf_counter()
            flushes.append((a, now, nbytes))
    env.window_closed()
    print(steadiness("rounds (s a round)", [b - a for a, b, _ in flushes],
                     host, sum(f[2] for f in flushes), now - t0),
          file=sys.stderr)
    readings = Readings(
        cell=env.cell["name"], kind="ingest", config=cfg, traffic=p,
        setup_s=setup_s, window=(t0, now),
        bytes_done=sum(f[2] for f in flushes), flushes=flushes,
        **tr.readings())
    if env.trace:
        w = readings.work["encode_scan"] = k1.work(
            B if cfg["mode"] == "std" else B - 1)
        readings.host_s["trace.k1_capture"] = k1.host_s
        print(f"trace: K1 capture {w['launches']} launches, "
              f"{w['capture_bytes']} bytes copied on the device, "
              f"{k1.host_s:.6f} s on the host, {k1.spilled} spilled",
              file=sys.stderr)
    attempted = fleet.attempted - attempted0
    fleet.close_all()
    env.free()
    return {"readings": readings, "attempted": attempted,
            "failed": fleet.failed - failed0,
            "checks": lambda ref, control=None: check(
                fleet, cfg, p, env.seed, ref, control)}
