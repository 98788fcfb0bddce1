"""``BENCHMARK.json`` keeps to the benchmark's contract, and the harness
finds configurations, traffic mixes, metrics and cells by name: a copy of
``bench/`` with a metric file and a cell entry added sees both, with no
other file edited."""
import json
import re
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench.harness.core import Bench, Readings, load_metric  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_text_fields():
    items = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] \
        + SPEC["per_layer"]
    for it in items:
        assert NAME.match(it["name"]), it["name"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
    for c in SPEC["configs"]:
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for m in SPEC["per_layer"]:
        assert TEXT.match(m["layer"])
    for kind in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[kind]]
        assert len(names) == len(set(names))
    metric_names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


def test_every_cell_reports_what_its_metrics_move():
    bench = Bench(ROOT / "bench")
    cells = {w["name"] for w in SPEC["workloads"]}
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in bench.metrics_of(w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert bench.metrics_of(w["name"], True), w["name"]
    for m in SPEC["per_layer"]:
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert m["moves"] in {e["name"] for e in
                                  bench.metrics_of(cell, False)}, m["name"]


def test_files_exist_under_paths():
    bench = Bench(ROOT / "bench")
    for c in SPEC["configs"]:
        assert c["file"].startswith("bench/")
        cfg = bench.config(c["name"])
        assert (ROOT / cfg["reference"]).is_file()
    for w in SPEC["workloads"]:
        assert w["config"] in {c["name"] for c in SPEC["configs"]}
        kind = bench.traffic(w["traffic"])["kind"]
        assert (ROOT / "bench" / "harness" / f"{kind}.py").is_file()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(load_metric(ROOT / "bench", m["name"]))
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_new_files_and_entries_are_found_without_edits(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    (tmp_path / "bench" / "metrics" / "flushes_per_s.ingest.py").write_text(
        "def read(r):\n    return len(r.flushes) / r.window_s\n")
    (tmp_path / "bench" / "traffic" / "fleet-small.json").write_text(
        json.dumps({**json.loads((ROOT / "bench" / "traffic" /
                                  "fleet-ingest.json").read_text()),
                    "streams": 64, "capacity": 64,
                    "max_batch_streams": 64}))
    spec["workloads"].append({"name": "mag-ingest-small", "config": "mag",
                              "traffic": "fleet-small", "chips": 1,
                              "why": "a smaller fleet"})
    spec["end_to_end"][0]["workloads"].append("mag-ingest-small")
    spec["per_layer"].append({"name": "flushes_per_s.ingest", "unit": "1/s",
                              "better": "higher", "source": "host_clock",
                              "layer": "coalescer and encoder",
                              "moves": "ingest_MBps"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(tmp_path / "bench")
    assert bench.cell("mag-ingest-small")["traffic"] == "fleet-small"
    assert bench.traffic("fleet-small")["streams"] == 64
    e2e = [m["name"] for m in bench.metrics_of("mag-ingest-small", False)]
    assert e2e == ["ingest_MBps", "setup_s"]
    layer = [m["name"] for m in bench.metrics_of("mag-ingest-small", True)]
    assert layer == ["flushes_per_s.ingest"]
    assert "flushes_per_s.ingest" in [
        m["name"] for m in bench.metrics_of("mag-ingest", True)]
    r = Readings(cell="mag-ingest-small", kind="ingest", config={},
                 traffic={}, setup_s=0.0, window=(0.0, 2.0),
                 flushes=[(0.0, 1.0, 8), (1.0, 2.0, 8)])
    assert load_metric(tmp_path / "bench", "flushes_per_s.ingest")(r) == 1.0
    with pytest.raises(KeyError):
        Bench(ROOT / "bench").cell("mag-ingest-small")
