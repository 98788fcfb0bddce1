"""Analyst reads (traffic ``kind`` ``"reads"``): window reads of an
archive through one ``DecompressionService``, a closed loop of clients
from one thread.

Parameters (the traffic file): the archive, ``channels`` x
``channel_samples`` of the configuration's signal from the seed, encoded
in set-up by the program (``container=True``, fed ``archive_feed_samples``
a channel at a time); ``clients`` in the closed loop, each sending its
next request when its answer arrives; a request's channel is uniform,
its window one of the ``window_samples`` classes ([low, high] samples),
each as often, its length log-uniform within the class and rounded up to
whole blocks (clipped to the channel), its start uniform; the service's
``FlushPolicy(max_batch_streams, max_batch_blocks, pipeline_depth)`` and
``cache_blocks``.  ``warm_requests`` requests run in set-up.

A request is due when its client sends it (when its previous answer
arrived, or the window opened) and done when its answer reaches the host.
At the window's end the pending batch is flushed; a request never
answered is failed.  The check: of the answered requests on
``check_channels`` channels drawn from the seed, ``check_requests`` drawn
uniformly over the whole window (a seeded reservoir), and the window's
longest, are decoded again by the plain reference from the archive's
samples.
"""
from __future__ import annotations

import collections
import sys
import time
from typing import Dict, List, Tuple

import numpy as np

from . import signals
from .core import Check, Readings
from .env import HostWatch, steadiness

__all__ = ["run"]

_BATCH = 4096


def event_ranges(rng, nb: int, count: int, classes, B: int):
    """``count`` (start, stop) block ranges over ``nb`` blocks of ``B``
    samples: a class of ``classes`` ([low, high] samples) each as often,
    the length log-uniform within it and rounded up to whole blocks
    (clipped to ``nb``), the start uniform."""
    cls = np.asarray(classes, dtype=np.float64)
    k = rng.integers(0, len(cls), count)
    lo, hi = np.log(cls[k, 0]), np.log(cls[k, 1])
    samples = np.exp(lo + (hi - lo) * rng.random(count))
    n = np.clip(np.ceil(samples / B).astype(np.int64), 1, nb)
    start = (rng.random(count) * (nb - n + 1)).astype(np.int64)
    return start, start + n


class Requests:
    """The seed's request sequence, drawn ``_BATCH`` at a time:
    ``get(k)`` is the k-th request (channel, start, stop)."""

    def __init__(self, p: dict, nb: int, B: int, seed: int):
        self.rng = np.random.default_rng([seed, 2])
        self.p, self.nb, self.B = p, nb, B
        self.ch = np.zeros(0, np.int64)
        self.lo = np.zeros(0, np.int64)
        self.hi = np.zeros(0, np.int64)

    def _more(self) -> None:
        ch = self.rng.integers(0, int(self.p["channels"]), _BATCH)
        lo, hi = event_ranges(self.rng, self.nb, _BATCH,
                              self.p["window_samples"], self.B)
        self.ch = np.concatenate([self.ch, ch])
        self.lo = np.concatenate([self.lo, lo])
        self.hi = np.concatenate([self.hi, hi])

    def get(self, k: int) -> Tuple[int, int, int]:
        while k >= len(self.ch):
            self._more()
        return int(self.ch[k]), int(self.lo[k]), int(self.hi[k])


class ClosedLoop:
    """``clients`` clients against one service; each answered request
    frees its client, which sends the next request of the sequence.  In
    the window it keeps, for the check, a seeded reservoir of
    ``check_requests`` answers among those on the ``check_channels`` and
    the longest answer."""

    def __init__(self, svc, reqs: Requests, clients: int):
        self.svc, self.reqs = svc, reqs
        self.ready = collections.deque((c, 0.0) for c in range(clients))
        self.inflight: Dict[str, tuple] = {}
        self.k = 0
        self.log: List[Tuple[float, float, int, int]] = []
        self.keep_channels: frozenset = frozenset()
        self.keep_n, self.seen, self.rng = 0, 0, None
        self.kept: List[Tuple[int, np.ndarray]] = []
        self.longest = (-1, -1, None)   # (blocks, k, answer)
        self.attempted = 0

    def _answer(self, res: Dict[str, np.ndarray]) -> None:
        done = time.perf_counter()
        for rid, arr in res.items():
            cid, k, ch, due, blocks = self.inflight.pop(rid)
            self.log.append((due, done, arr.nbytes, blocks))
            self.ready.append((cid, done))
            if ch in self.keep_channels:
                self._reservoir(k, arr)
            if blocks > self.longest[0]:
                self.longest = (blocks, k, arr)

    def _reservoir(self, k: int, arr: np.ndarray) -> None:
        self.seen += 1
        if len(self.kept) < self.keep_n:
            self.kept.append((k, arr))
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.keep_n:
            self.kept[j] = (k, arr)

    def open_window(self, keep_channels, keep_n: int, rng) -> None:
        """Every client is idle between set-up and the window: each is
        due when the window opens.  From here the answers on
        ``keep_channels`` feed a reservoir of ``keep_n`` drawn by
        ``rng``."""
        now = time.perf_counter()
        self.ready = collections.deque((c, now) for c, _ in self.ready)
        self.log, self.longest, self.attempted = [], (-1, -1, None), 0
        self.keep_channels, self.keep_n, self.rng = (
            frozenset(keep_channels), int(keep_n), rng)
        self.kept, self.seen = [], 0

    def step(self) -> None:
        if not self.ready:
            self._answer(self.svc.flush())
            return
        cid, due = self.ready.popleft()
        k = self.k
        self.k += 1
        ch, lo, hi = self.reqs.get(k)
        rid = str(k)
        self.inflight[rid] = (cid, k, ch, due, hi - lo)
        self.attempted += 1
        res = self.svc.submit(rid, "archive", lo, hi, ch)
        if res:
            self._answer(res)

    def drain(self) -> None:
        self._answer(self.svc.flush())

    def run_for(self, count: int) -> None:
        for _ in range(count):
            self.step()
        self.drain()


def encode_archive(env, table: np.ndarray, p: dict) -> bytes:
    """The program encodes the archive: one ``container=True`` session
    over every channel, fed ``archive_feed_samples`` at a time."""
    from repro_torch.core import IdealemCodec
    codec = IdealemCodec(backend="cuda", device=str(env.device),
                         **env.codec_kwargs())
    sess = codec.session(channels=len(table), container=True)
    step = int(p["archive_feed_samples"])
    for a in range(0, table.shape[1], step):
        sess.feed(table[:, a:a + step])
    return sess.finish()


def check(loop: ClosedLoop, table: np.ndarray, cfg: dict, seed: int, ref,
          unanswered: int, control=None) -> List[Check]:
    """Decode the kept answers' windows with the reference and count the
    samples whose bits differ from the service's answers; with
    ``control`` (a dtype), from the reference's own decode in that
    precision instead."""
    kept = dict(loop.kept)
    blocks, k, arr = loop.longest
    if arr is not None:
        kept[k] = arr
    by_ch: Dict[int, list] = {}
    for k, got in kept.items():
        ch, lo, hi = loop.reqs.get(k)
        by_ch.setdefault(ch, []).append((lo, hi, got))
    diff, dseed = 0, _decode_seed(seed)
    for ch, items in sorted(by_ch.items()):
        chan = ref.Channel(cfg, table[ch])
        ctl = None if control is None else ref.Channel(cfg, table[ch],
                                                       dtype=control)
        for lo, hi, got in items:
            want = ref.reconstruct(chan, lo, hi, seed=dseed)
            if ctl is not None:
                got = ref.reconstruct(ctl, lo, hi, seed=dseed).astype(
                    np.float64)
            m = min(len(got), len(want))
            diff += int(np.count_nonzero(
                got[:m].view(np.uint64) != want[:m].view(np.uint64)))
            diff += abs(len(got) - len(want))
    print(f"check: {len(kept)} answered windows compared on channels "
          f"{sorted(by_ch)}", file=sys.stderr)
    return [Check("window_samples_differing", diff, 0),
            Check("requests_unanswered", unanswered, 0)]


def _decode_seed(seed: int) -> int:
    return int(seed) % (1 << 32)


def run(env) -> dict:
    """Set up, warm, measure and check one read cell (see the module
    docstring); ``env`` is ``harness.env.Env``."""
    torch, dev, p, cfg = env.torch, env.device, env.traffic, env.config
    from repro_torch.serve import DecompressionService, FlushPolicy

    B = int(cfg["block_size"])
    table = signals.make_table(torch, cfg["signal"], int(p["channels"]),
                               int(p["channel_samples"]), env.seed, dev)
    blob = encode_archive(env, table, p)
    svc = DecompressionService(
        policy=FlushPolicy(max_batch_streams=int(p["max_batch_streams"]),
                           max_batch_blocks=int(p["max_batch_blocks"]),
                           pipeline_depth=int(p["pipeline_depth"])),
        cache_blocks=int(p["cache_blocks"]), backend="cuda",
        device=str(dev))
    svc.attach("archive", blob, seed=_decode_seed(env.seed))
    del blob
    nb = int(p["channel_samples"]) // B
    reqs = Requests(p, nb, B, env.seed)
    loop = ClosedLoop(svc, reqs, int(p["clients"]))
    warm = int(p["warm_requests"])
    loop.run_for(warm)
    env.sync()
    setup_s = time.perf_counter() - env.t_start

    rng = np.random.default_rng([env.seed, 1])
    keep = rng.choice(int(p["channels"]), replace=False,
                      size=min(int(p["check_channels"]), int(p["channels"])))
    tr = env.tracer(spans=("serve.plan", "serve.gather", "serve.reconstruct",
                           "serve.emit"), timed=())
    with tr, HostWatch() as host:
        loop.open_window([int(c) for c in keep], int(p["check_requests"]),
                         rng)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < env.seconds:
            loop.step()
        loop.drain()
        t1 = time.perf_counter()
    env.window_closed()
    per_s = collections.Counter(int(done - t0) for _, done, _, _ in loop.log)
    print(steadiness("seconds (answers a second)",
                     [per_s[i] for i in range(int(t1 - t0))], host,
                     sum(r[2] for r in loop.log), t1 - t0),
          file=sys.stderr)
    readings = Readings(
        cell=env.cell["name"], kind="reads", config=cfg, traffic=p,
        setup_s=setup_s, window=(t0, t1),
        bytes_done=sum(r[2] for r in loop.log), requests=loop.log,
        **tr.readings())
    unanswered = len(loop.inflight)   # failed requests are never answered
    svc.close()
    env.free()
    return {"readings": readings, "attempted": loop.attempted,
            "failed": unanswered,
            "checks": lambda ref, control=None: check(
                loop, table, cfg, env.seed, ref, unanswered, control)}
