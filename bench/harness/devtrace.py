"""The device side of a traced run: ``torch.profiler`` over the measured
window, its kernels and copies put on the host's ``perf_counter`` clock,
the union of their intervals (busy seconds), the idle time between them
split by the host span open at each moment, and the breakdown a traced
result carries.

The interval arithmetic is ``chip_smoke.py:device_profile``'s (frozen
here): device activity is every event the profiler puts on the CUDA
device (kernels, copies, sets), busy time the union of their intervals.
The clock is tied to the host by a marker: after a synchronise the
harness stamps ``perf_counter`` and launches one short kernel, the first
device event of the trace.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["DeviceTrace", "union_seconds", "idle_gaps", "label_gaps",
           "top_names"]

Interval = Tuple[float, float]


def union_seconds(intervals: Sequence[Interval], lo: float,
                  hi: float) -> float:
    """Seconds of [lo, hi) covered by the union of ``intervals``."""
    busy, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    return busy


def idle_gaps(intervals: Sequence[Interval], lo: float,
              hi: float) -> List[Interval]:
    """The stretches of [lo, hi) that no interval covers."""
    gaps, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]


def label_gaps(gaps: Sequence[Interval],
               spans: Dict[str, List[Interval]],
               order: Sequence[str]) -> Dict[str, float]:
    """Idle seconds by what the host was doing: each stretch of a gap
    goes to the first name of ``order`` (innermost first) with a span open
    over it, else to ``"harness"`` (the benchmark between calls into the
    program)."""
    events = []                       # (time, kind, rank): kind +1 opens
    for rank, name in enumerate(order):
        for a, b in spans.get(name, ()):
            events += [(a, 1, rank), (b, -1, rank)]
    gap_rank = len(order)
    for a, b in gaps:
        events += [(a, 1, gap_rank), (b, -1, gap_rank)]
    events.sort()
    open_ = [0] * (len(order) + 1)
    out: Dict[str, float] = {}
    prev = None
    for t, kind, rank in events:
        if prev is not None and t > prev and open_[gap_rank]:
            label = next((order[k] for k in range(len(order)) if open_[k]),
                         "harness")
            out[label] = out.get(label, 0.0) + (t - prev)
        open_[rank] += kind
        prev = t
    return out


def top_names(totals: Dict[str, float], k: int = 10) -> List[list]:
    return [[name, sec] for name, sec in
            sorted(totals.items(), key=lambda kv: -kv[1])[:k]]


class DeviceTrace:
    """``with DeviceTrace(torch, dev) as tr: <window>``; afterwards
    ``tr.events`` holds ``(name, start_s, end_s)`` of every device event
    on the host's ``perf_counter`` clock."""

    def __init__(self, torch, device):
        self.torch = torch
        self.device = device
        self.events: List[Tuple[str, float, float]] = []
        self._prof = None
        self._mark: Optional[float] = None

    def __enter__(self):
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize(self.device)
        self._mark = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(self.device)
        return self

    def __exit__(self, *exc):
        torch = self.torch
        torch.cuda.synchronize(self.device)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        raw = []
        for e in self._prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            raw.append((e.name, e.time_range.start * 1e-6,
                        e.time_range.end * 1e-6))
        raw.sort(key=lambda ev: ev[1])
        if raw:
            shift = self._mark - raw[0][1]
            self.events = [(n, a + shift, b + shift) for n, a, b in raw[1:]]
        return False
