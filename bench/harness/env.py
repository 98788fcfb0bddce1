"""One run of one cell: the environment a runner works in, the traced
window's recorders, and the result it prints."""
from __future__ import annotations

import gc
import importlib.util
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import devtrace
from .core import Bench, Check, load_metric, registry_values, result_line

__all__ = ["Env", "HostWatch", "run_cell", "steadiness"]

CODEC_KEYS = ("mode", "block_size", "num_dict", "alpha", "rel_tol",
              "max_count", "value_range")


class WindowTrace:
    """Around a traced window: the program's spans named ``spans`` (an
    exporter on its tracer), host intervals of the program's methods
    ``timed`` ((name, class, method) wrapped for the window), the
    registry's change, and the device trace.  A no-op when the run is not
    traced."""

    def __init__(self, env: "Env", spans: Sequence[str],
                 timed: Sequence[Tuple[str, type, str]]):
        self.env, self.on = env, env.trace
        self.timed = list(timed)
        self.order = [t[0] for t in timed] + list(spans)
        self.spans: Dict[str, List[Tuple[float, float]]] = {
            n: [] for n in self.order}
        self.host_s: Dict[str, float] = {t[0]: 0.0 for t in timed}
        self.delta: Dict[str, float] = {}
        self.dev = None
        self._held = []

    def _export(self, rec) -> None:
        iv = self.spans.get(rec.name)
        if iv is not None and rec.kind == "span":
            iv.append((rec.start_s, rec.start_s + rec.duration_s))

    def _wrap(self, name, fn):
        iv, acc = self.spans[name], self.host_s

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                t1 = time.perf_counter()
                iv.append((t0, t1))
                acc[name] += t1 - t0
        return timed

    def __enter__(self):
        if not self.on:
            return self
        from repro_torch import obs
        self._reg0 = registry_values(obs)
        obs.tracer().add_exporter(self._export)
        for name, cls, meth in self.timed:
            self._held.append((cls, meth, vars(cls)[meth]))
            setattr(cls, meth, self._wrap(name, getattr(cls, meth)))
        if self.env.device.type == "cuda":
            self.dev = devtrace.DeviceTrace(self.env.torch, self.env.device)
            self.dev.__enter__()
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        from repro_torch import obs
        try:
            if self.dev is not None:
                self.dev.__exit__(*exc)
        finally:
            for cls, meth, held in self._held:
                setattr(cls, meth, held)
            obs.tracer().remove_exporter(self._export)
        reg1 = registry_values(obs)
        self.delta = {k: v - self._reg0.get(k, 0.0) for k, v in reg1.items()}
        return False

    def readings(self) -> dict:
        if not self.on:
            return {}
        return {"host_s": dict(self.host_s), "registry_delta": self.delta,
                "spans": self.spans,
                "device_events": None if self.dev is None
                else self.dev.events}


def _steal_s() -> Optional[float]:
    """Seconds the hypervisor gave the machine's CPUs to others (the
    ``steal`` column of ``/proc/stat``, summed over CPUs), or ``None``."""
    try:
        with open("/proc/stat") as f:
            cols = f.readline().split()
        return int(cols[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def host_probe_s() -> float:
    """Seconds a fixed piece of pure-Python work (integer arithmetic and
    dictionary inserts and lookups, ~0.2 s) takes: the host's speed per
    instruction, read after the window beside its rate."""
    t0 = time.perf_counter()
    d: Dict[int, int] = {}
    for i in range(400_000):
        d[i * 7919 % 1_000_003] = i
    acc = 0
    for i in range(400_000):
        acc += d.get(i, 0) ^ (i * i)
    return time.perf_counter() - t0


class HostWatch:
    """Around the window, what the host did besides the work: the
    interpreter's garbage collector (collections, seconds), the CPUs'
    steal time, the window thread's and the process's CPU seconds and
    the process's threads (printed on standard error beside the window's
    own steadiness)."""

    def __init__(self):
        self.seconds, self.count, self._t0 = 0.0, 0, None
        self.steal = None
        self.sched: Dict[str, object] = {}

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self.count += 1
            self._t0 = None

    @staticmethod
    def _sample():
        return time.perf_counter(), time.thread_time(), time.process_time()

    def __enter__(self):
        self._steal0 = _steal_s()
        self._s0 = self._sample()
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)
        s1 = self._sample()
        steal = _steal_s()
        if steal is not None and self._steal0 is not None:
            self.steal = steal - self._steal0
        s0 = self._s0
        try:
            threads = len(os.listdir("/proc/self/task"))
        except OSError:
            threads = None
        self.sched = {"wall_s": round(s1[0] - s0[0], 6),
                      "thread_cpu_s": round(s1[1] - s0[1], 6),
                      "process_cpu_s": round(s1[2] - s0[2], 6),
                      "threads": threads}
        return False


def steadiness(label: str, durations: Sequence[float], host: HostWatch,
               nbytes: int, seconds: float) -> str:
    """One line on the window's own steadiness: its units of work (rounds
    or seconds), their median and quartiles, what :class:`HostWatch` saw,
    the window's rate (MB/s; a traced run prints it too) and, read after
    the window, :func:`host_probe_s`."""
    d = sorted(durations)
    q = (lambda f: d[min(len(d) - 1, int(f * len(d)))]) if d else (
        lambda f: 0.0)
    return (f"window: {len(d)} {label}, median {q(0.5):.6f}, quartiles "
            f"{q(0.25):.6f} {q(0.75):.6f}; gc {host.count} collections "
            f"{host.seconds:.6f} s; steal {host.steal} s; "
            f"{nbytes / seconds / 1e6:.6f} MB/s; host "
            + " ".join(f"{k}={v}" for k, v in host.sched.items())
            + f" probe_s={host_probe_s():.6f}")


class Env:
    """What a runner (``harness/<kind>.py``) is given."""

    def __init__(self, torch, device, bench: Bench, cell: dict, seed: int,
                 seconds: float, trace: bool, t_start: float,
                 config: Optional[dict] = None,
                 traffic: Optional[dict] = None):
        self.torch, self.device, self.bench = torch, device, bench
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.t_start = bool(trace), t_start
        self.config = config if config is not None else bench.config(
            cell["config"])
        self.traffic = traffic if traffic is not None else bench.traffic(
            cell["traffic"])
        self.memory_peak: Optional[int] = None
        self._tracer: Optional[WindowTrace] = None

    def codec_kwargs(self) -> dict:
        kw = {k: self.config[k] for k in CODEC_KEYS if k in self.config}
        if kw.get("value_range") is not None:
            kw["value_range"] = tuple(kw["value_range"])
        return kw

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def tracer(self, spans: Sequence[str],
               timed: Sequence[Tuple[str, type, str]]) -> WindowTrace:
        """Recorders for the window; ``spans`` and ``timed`` innermost
        first (idle time goes to the first name open over it)."""
        self._tracer = WindowTrace(self, spans, timed)
        return self._tracer

    def window_closed(self) -> None:
        self.sync()
        if self.device.type == "cuda":
            self.memory_peak = int(
                self.torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()


def power_limit_w() -> Optional[float]:
    """The card's ``power.limit`` in watts (``nvidia-smi``), or ``None``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def load_reference(bench: Bench, config: dict):
    """The configuration's plain reference module (its ``reference``
    path, relative to the repository root)."""
    path = bench.root.parent / config["reference"]
    spec = importlib.util.spec_from_file_location("bench_reference", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def run_cell(torch, device, bench: Bench, cell_name: str, seed: int,
             seconds: float, trace: bool, t_start: float,
             control=None, config=None, traffic=None, chips: int = 1):
    """Run one cell; returns ``(result line, check lines)``.  ``control`` (a dtype) puts the reference in that precision
    in the program's place for the check; ``config``/``traffic`` replace
    the named files (tests)."""
    from importlib import import_module
    cell = bench.cell(cell_name)
    env = Env(torch, device, bench, cell, seed, seconds, trace, t_start,
              config=config, traffic=traffic)
    runner = import_module(f"{__package__}.{env.traffic['kind']}")
    out = runner.run(env)
    r = out["readings"]
    r.power_limit_w = power_limit_w() if device.type == "cuda" else None

    metrics: Dict[str, dict] = {}
    for m in bench.metrics_of(cell_name, trace):
        v = load_metric(bench.root, m["name"])(r)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": chips,
        "memory_peak_bytes": env.memory_peak or 0,
        "power_limit_w": r.power_limit_w,
    }
    breakdown = None
    if trace and r.device_events is not None:
        lo, hi = r.window
        iv = [(a, b) for _, a, b in r.device_events if b > lo and a < hi]
        device_info["busy_s"] = devtrace.union_seconds(iv, lo, hi)
        device_info["window_s"] = r.window_s
        by_name: Dict[str, float] = {}
        for n, a, b in r.device_events:
            by_name[n[:120]] = by_name.get(n[:120], 0.0) + (b - a)
        gaps = devtrace.idle_gaps(iv, lo, hi)
        order = env._tracer.order if env._tracer is not None else []
        breakdown = {
            "device_ops": devtrace.top_names(by_name),
            "idle_gaps": devtrace.top_names(
                devtrace.label_gaps(gaps, r.spans, order))}

    ref = load_reference(bench, env.config)
    checks: List[Check] = out["checks"](
        ref, None if control is None else np.dtype(control))
    correct = all(c.ok for c in checks) and out["failed"] == 0
    lines = [f"check {c.name} = {c.value} (limit {c.limit})" for c in checks]
    return (result_line(correct, out["attempted"], out["failed"], metrics,
                        device_info, breakdown, checks), lines)
