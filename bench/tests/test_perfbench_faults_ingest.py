"""The ingest cells' comparison fails when the timed path is broken: a run
on the CPU at a small size (the card's look skipped, the kernels' plain
versions) comes out correct, and comes out not correct with each fault
planted underneath -- the scan returning its carry unchanged, half of a
flush's streams left out, a segment altered where the session writes
it -- and with the float32 control in the program's place."""
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

SEED = 2**33 + 12345


def _run(cell="mag-ingest", control=None, trace=False):
    bench = Bench(ROOT / "bench")
    c = bench.cell(cell)
    cfg = {**bench.config(c["config"]), "num_dict": 16}
    tr = {**bench.traffic(c["traffic"]), "streams": 8, "capacity": 8,
          "max_batch_streams": 8, "stream_life_samples": 2**13,
          "chunk_samples": 512, "pool_rows": 8, "check_streams": 6}
    line, _ = run_cell(torch, torch.device("cpu"), bench, cell, SEED, 0.3,
                       trace, time.perf_counter(), control=control,
                       config=cfg, traffic=tr)
    return json.loads(line)


def test_traced_run_reports_its_per_layer_metrics():
    """On the CPU a traced run has no device trace: the metrics read from
    host spans and the registry are there, the device ones left out."""
    res = _run(trace=True)
    assert res["correct"]
    assert set(res["metrics"]) == {"session_share.ingest",
                                   "decide_share.ingest"}
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("cell", ["mag-ingest", "ang-delta-ingest"])
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert all(v["value"] == 0 for v in res["checks"].values())


def test_float32_control_is_not_correct():
    res = _run(control="float32")
    assert not res["correct"]
    assert res["checks"]["stream_bytes_differing"]["value"] > 0


def _state_unchanged(monkeypatch):
    from repro_torch.kernels import encode_step
    real = encode_step.encode_scan

    def stale(xs, valid, state, **kw):
        out, _ = real(xs, valid, state, **kw)
        return out, state

    monkeypatch.setattr(encode_step, "encode_scan", stale)


def _half_batch(monkeypatch):
    from repro_torch.serve.compress import StreamCoalescer
    real = StreamCoalescer._flush_impl

    def half(self, stream_ids):
        out = real(self, stream_ids)
        return {k: v for i, (k, v) in enumerate(sorted(out.items()))
                if i % 2 == 0}

    monkeypatch.setattr(StreamCoalescer, "_flush_impl", half)


def _answer_altered(monkeypatch):
    from repro_torch.core.session import IdealemSession
    real = IdealemSession.commit

    def altered(self, prep, decisions):
        outs = real(self, prep, decisions)
        seg = outs[0]
        return [seg[:-1] + bytes([seg[-1] ^ 1])] + outs[1:]

    monkeypatch.setattr(IdealemSession, "commit", altered)


@pytest.mark.parametrize("plant", [_state_unchanged, _half_batch,
                                   _answer_altered],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered"])
def test_planted_fault_is_not_correct(plant, monkeypatch):
    plant(monkeypatch)
    res = _run()
    assert not res["correct"]
    assert any(v["value"] > v["limit"] for v in res["checks"].values())
