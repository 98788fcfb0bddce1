"""The read cells' comparison fails when the timed path is broken: a run
on the CPU at a small size (the card's look skipped, the kernels' plain
versions) comes out correct, and comes out not correct with each fault
planted underneath -- half of a flush's answers left out, every answer
altered where the decode produces it -- and with the float32 control in
the program's place.  (A read holds no state from one request to the
next, so the carry-left-unchanged fault has nothing to break here.)"""
import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness.core import Bench  # noqa: E402
from bench.harness.env import run_cell  # noqa: E402

SEED = 2**33 + 54321

# The delta-mode read path (K2) has no cell in BENCHMARK.json (its rate
# spreads too widely on the card's host for the contract's largest
# bound); its comparison is still held here, on this cell entry.
DELTA_READ = {"name": "ang-delta-read", "config": "ang-delta",
              "traffic": "analyst-reads", "chips": 1,
              "why": "delta-mode reads: store gather, copies and K2"}


def _run(cell="ang-delta-read", control=None, trace=False):
    bench = Bench(ROOT / "bench")
    if cell not in {w["name"] for w in bench.spec["workloads"]}:
        bench.spec["workloads"].append(DELTA_READ)
    c = bench.cell(cell)
    cfg = {**bench.config(c["config"]), "num_dict": 16}
    tr = {**bench.traffic(c["traffic"]), "channels": 4,
          "channel_samples": 2**14, "archive_feed_samples": 2**12,
          "clients": 8, "window_samples": [[1, 60], [60, 2000]],
          "warm_requests": 16, "check_channels": 2, "check_requests": 6,
          "max_batch_streams": 8,
          "max_batch_blocks": 128}
    line, _ = run_cell(torch, torch.device("cpu"), bench, cell, SEED, 0.3,
                       trace, time.perf_counter(), control=control,
                       config=cfg, traffic=tr)
    return json.loads(line)


def test_traced_run_reports_its_per_layer_metrics():
    """On the CPU a traced run has no device trace: the metrics read from
    host spans and the registry are there, the device ones left out."""
    res = _run("mag-read", trace=True)
    assert res["correct"]
    assert set(res["metrics"]) == {"read_p95_ms.read", "gather_share.read"}
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("cell", ["ang-delta-read", "mag-read"])
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert all(v["value"] == 0 for v in res["checks"].values())


@pytest.mark.parametrize("cell", ["ang-delta-read", "mag-read"])
def test_float32_control_is_not_correct(cell):
    res = _run(cell, control="float32")
    assert not res["correct"]
    assert res["checks"]["window_samples_differing"]["value"] > 0


def _half_batch(monkeypatch):
    from repro_torch.serve.compress import DecompressionService
    real = DecompressionService._emit_impl

    def half(self, *a, **kw):
        out = real(self, *a, **kw)
        return {k: v for i, (k, v) in enumerate(sorted(out.items()))
                if i % 2 == 0}

    monkeypatch.setattr(DecompressionService, "_emit_impl", half)


def _answer_altered(monkeypatch):
    from repro_torch.core import decode
    real = decode.reconstruct

    def altered(plan, *a, **kw):
        out = real(plan, *a, **kw).copy()
        out[:, 0] += 1.0
        return out

    monkeypatch.setattr(decode, "reconstruct", altered)


@pytest.mark.parametrize("plant", [_half_batch, _answer_altered],
                         ids=["half_batch", "answer_altered"])
def test_planted_fault_is_not_correct(plant, monkeypatch):
    plant(monkeypatch)
    res = _run()
    assert not res["correct"]
    assert any(v["value"] > v["limit"] for v in res["checks"].values())
