"""The traffic is the seed's: the same seed gives the same signal table,
the same fleet and the same request sequence, another seed another; the
read windows keep to their duration classes; the read check's reservoir
draws from the whole window."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import ingest, reads, signals  # noqa: E402

SEED = 2**33 + 777


def _config(name):
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())


def _traffic(name):
    return json.loads((ROOT / "bench" / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("config", ["mag", "ang-delta"])
def test_signal_table_follows_the_seed(config):
    sig = _config(config)["signal"]
    a = signals.make_table(torch, sig, 5, 4096, SEED, "cpu")
    b = signals.make_table(torch, sig, 5, 4096, SEED, "cpu")
    c = signals.make_table(torch, sig, 5, 4096, SEED + 1, "cpu")
    assert a.shape == (5, 4096) and a.dtype == np.float64
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


class _Coalescer:
    """Stands in for ``StreamCoalescer``: records what the fleet sends."""

    def __init__(self):
        self.sent = []

    def open_stream(self, sid):
        pass

    def submit(self, sid, chunk):
        self.sent.append((sid, len(chunk), float(chunk[0])))
        return None

    def flush(self):
        return {}

    def close_stream(self, sid):
        return b""


def _fleet_rounds(seed, rounds=3):
    p = {**_traffic("fleet-ingest"), "streams": 12, "pool_rows": 12,
         "chunk_samples": 64, "stream_life_samples": 256}
    pool = np.random.default_rng(0).random((12, 256))
    co = _Coalescer()
    fleet = ingest.Fleet(co, pool, p, 32, seed)
    for _ in range(rounds):
        fleet.round()
    return co.sent, [fleet.streams[s].start for s in sorted(fleet.streams)]


def test_fleet_follows_the_seed_in_lock_step():
    sent, starts = _fleet_rounds(SEED)
    assert (sent, starts) == _fleet_rounds(SEED)
    assert starts != _fleet_rounds(SEED + 1)[1]
    assert {n for _, n, _ in sent} == {64}
    assert all(s % 64 == 0 for s in starts)


def test_requests_follow_the_seed_and_their_classes():
    p = _traffic("analyst-reads")
    B, nb = 32, 2**15
    a = reads.Requests(p, nb, B, SEED)
    b = reads.Requests(p, nb, B, SEED)
    c = reads.Requests(p, nb, B, SEED + 1)
    ka = [a.get(k) for k in range(5000)]
    assert ka == [b.get(k) for k in range(5000)]
    assert ka != [c.get(k) for k in range(5000)]
    ch, lo, hi = (np.array(v) for v in zip(*ka))
    assert ch.min() >= 0 and ch.max() < p["channels"]
    assert lo.min() >= 0 and hi.max() <= nb
    n = hi - lo
    cls = np.array(p["window_samples"])
    assert n.min() >= 1 and n.max() <= -(-cls[-1, 1] // B)
    # each class as often: the longest class (over 225 blocks) takes a
    # quarter of the requests
    share = np.mean(n > cls[-1, 0] // B)
    assert 0.2 < share < 0.3


def test_check_reservoir_spans_the_window():
    def kept(seed):
        loop = reads.ClosedLoop(None, None, 1)
        loop.open_window([0], 256, np.random.default_rng([seed, 1]))
        for k in range(20000):
            loop._reservoir(k, None)
        return sorted(k for k, _ in loop.kept)

    ks = kept(SEED)
    assert len(ks) == 256 and ks == kept(SEED)
    assert ks != kept(SEED + 1)
    thirds = np.histogram(ks, bins=[0, 6667, 13334, 20000])[0]
    assert thirds.min() > 50
