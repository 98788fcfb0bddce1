"""What every cell shares: ``BENCHMARK.json`` and the files it names,
found by name (``configs/<name>.json``, ``traffic/<name>.json``,
``metrics/<name>.py``), the readings a run hands the metric readers, and
the result line.

A traffic file names its ``kind``, the runner that reads it
(``harness/<kind>.py``: ``ingest`` or ``reads``); everything else in it is
that runner's parameters.  A metric file defines ``read(r)``, where ``r``
is the run's :class:`Readings`, and returns a number, or ``None`` when
the run holds nothing for it to read (the metric is then left out).
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

__all__ = ["Bench", "Readings", "Check", "load_metric", "percentile"]

#: Top-level module names the timed process must not hold (JAX and the
#: JAX package; ``repro_torch`` is another name).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Check:
    """One number compared with the plain reference, and its limit: the
    run is correct only where ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Readings:
    """What a run hands the metric readers.  Times are host
    ``perf_counter`` seconds; ``window`` is the measured window's
    (start, end).  The traced run adds ``device_events`` and ``spans``;
    ``None`` or empty where the run did not record them."""

    cell: str
    kind: str
    config: dict
    traffic: dict
    setup_s: float
    window: Tuple[float, float]
    # the work the window completed, in f64 bytes of samples
    bytes_done: int = 0
    # answered requests: (due, done, f64 bytes, blocks) -- a request is
    # due when its client sent it (closed loop: when its previous answer
    # arrived)
    requests: List[Tuple[float, float, int, int]] = field(
        default_factory=list)
    # flushes: (start, end, f64 bytes fed whose segments came back)
    flushes: List[Tuple[float, float, int]] = field(default_factory=list)
    # host seconds the harness timed around the program's calls, by name
    host_s: Dict[str, float] = field(default_factory=dict)
    # the program's registry over the window: histogram sums and counter
    # values, end minus start, by "family{label=value,...}"
    registry_delta: Dict[str, float] = field(default_factory=dict)
    # traced runs: device events (name, start, end) and host spans by name
    device_events: Optional[List[Tuple[str, float, float]]] = None
    spans: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    # kernel work reckoned from the window's inputs, by kernel:
    # {"bytes", "ops", "launches"}
    work: Dict[str, dict] = field(default_factory=dict)
    power_limit_w: Optional[float] = None

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def device_seconds(self, names) -> Optional[float]:
        """Summed device seconds of the events whose name holds any of
        ``names``; ``None`` without a trace or without such an event."""
        if not self.device_events:
            return None
        hits = [b - a for n, a, b in self.device_events
                if any(k in n for k in names)]
        return sum(hits) if hits else None


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (nearest rank) of ``values``."""
    vals = sorted(values)
    k = max(0, math.ceil(q / 100.0 * len(vals)) - 1)
    return vals[k]


def registry_values(obs) -> Dict[str, float]:
    """Flat view of the program's registry: counters and gauges by value,
    histograms by ``<name>.sum`` and ``<name>.count``."""
    out: Dict[str, float] = {}
    for name, fam in obs.registry().snapshot().items():
        for v in fam["values"]:
            labels = ",".join(f"{k}={v['labels'][k]}"
                              for k in sorted(v["labels"]))
            key = f"{name}{{{labels}}}" if labels else name
            if "sum" in v:
                out[key + ".sum"] = float(v["sum"])
                out[key + ".count"] = float(v["count"])
            else:
                out[key] = float(v["value"])
    return out


def load_metric(root: Path, name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root`` (the
    benchmark's folder; ``BENCHMARK.json`` is in its parent)."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = json.loads(
            (self.root.parent / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root.parent / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads(
            (self.root / "traffic" / f"{name}.json").read_text())

    def metrics_of(self, cell: str, traced: bool) -> List[dict]:
        """The cell's end-to-end metrics (``traced`` False) or per-layer
        metrics (True): those whose ``workloads`` list the cell, or, with
        no such list, every cell that reports what they need (end to end:
        every cell; per layer: the cells reporting the metric it moves)."""
        e2e = [m for m in self.spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not traced:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, dict], device: dict,
                breakdown: Optional[dict], checks: List[Check]) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    return json.dumps(out)
