"""Dependency-free metrics registry: counters, gauges, histograms.

The port's runtime telemetry.  Three instrument kinds,
Prometheus-shaped so the text exposition in :mod:`repro_torch.obs.export` is a
direct serialization:

* :class:`Counter` -- monotone float accumulator (``inc``).
* :class:`Gauge` -- settable level (``set`` / ``inc`` / ``dec``).
* :class:`Histogram` -- fixed-bucket distribution with cumulative bucket
  counts, ``sum`` and ``count``.  The default bucket ladder is
  log-spaced for latencies (1 us .. 10 s, half-decade steps).

Instruments hang off a :class:`MetricsRegistry` in *families*: one family
per metric name, one child per label-set.  ``registry()`` returns the
process-default registry that all of the port's layers write into; tests build
private registries when they need isolation.

Concurrency: a registry lock guards family/child creation, and every
child carries its own lock for value updates -- writers on different
metrics never contend.  ``set_enabled(False)`` turns every write into an
early return.

Naming scheme (the reference package's): ``repro_<layer>_<name>``, counters
suffixed ``_total``, latency histograms suffixed ``_seconds``.
"""
from __future__ import annotations

import bisect
import math
import re
import threading
from typing import Dict, Iterable, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS", "registry", "set_enabled",
]

# 1 us .. 10 s in half-decade steps: wide enough for a kernel launch and
# a cold kernel build alike, small enough (15 buckets) to export everywhere.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    round(10.0 ** (e / 2.0), 10) for e in range(-12, 3))

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

LabelItems = Tuple[Tuple[str, str], ...]


def _label_items(labels: Optional[Dict[str, str]]) -> LabelItems:
    if not labels:
        return ()
    items = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
    for k, _ in items:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name: {k!r}")
    return items


class _Child:
    """Common base: one (name, label-set) instrument with its own lock."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str,
                 labels: LabelItems) -> None:
        self._registry = registry
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()


class Counter(_Child):
    """Monotone accumulator.  ``inc`` with a negative amount raises."""

    kind = "counter"

    def __init__(self, registry, name, labels) -> None:
        super().__init__(registry, name, labels)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not self._registry.enabled:
            return
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Gauge(_Child):
    """Settable level (in-flight depth, open streams, ...)."""

    kind = "gauge"

    def __init__(self, registry, name, labels) -> None:
        super().__init__(registry, name, labels)
        self._value = 0.0

    def set(self, value: float) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if not self._registry.enabled:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Histogram(_Child):
    """Fixed-bucket distribution.  ``bucket_counts`` are per-bucket (not
    cumulative); the exporter cumulates for the ``le`` convention.  A
    value lands in the first bucket whose upper bound is >= value
    (Prometheus ``le`` semantics); larger values land in +Inf."""

    kind = "histogram"

    def __init__(self, registry, name, labels,
                 buckets: Sequence[float]) -> None:
        super().__init__(registry, name, labels)
        bounds = tuple(float(b) for b in buckets)
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError("histogram buckets must be sorted and unique")
        if any(not math.isfinite(b) for b in bounds):
            raise ValueError("histogram buckets must be finite (+Inf is "
                             "implicit)")
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last slot = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        if not self._registry.enabled:
            return
        value = float(value)
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def bucket_counts(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._sum = 0.0
            self._count = 0


class _Family:
    def __init__(self, name: str, kind: str, help: str,
                 buckets: Optional[Tuple[float, ...]]) -> None:
        self.name = name
        self.kind = kind
        self.help = help
        self.buckets = buckets
        self.children: Dict[LabelItems, _Child] = {}


class MetricsRegistry:
    """Families of named instruments; see the module docstring."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}

    # ------------------------------------------------------------ factories
    def _child(self, name: str, kind: str, help: str,
               labels: Optional[Dict[str, str]],
               buckets: Optional[Sequence[float]] = None) -> _Child:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name: {name!r}")
        items = _label_items(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(
                    name, kind, help,
                    tuple(float(b) for b in buckets) if buckets else None)
                self._families[name] = fam
            else:
                if fam.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind}")
                if kind == "histogram" and buckets is not None \
                        and fam.buckets != tuple(float(b) for b in buckets):
                    raise ValueError(
                        f"metric {name!r} already registered with different "
                        "buckets")
                if help and not fam.help:
                    fam.help = help
            child = fam.children.get(items)
            if child is None:
                if kind == "counter":
                    child = Counter(self, name, items)
                elif kind == "gauge":
                    child = Gauge(self, name, items)
                else:
                    child = Histogram(self, name, items,
                                      fam.buckets or DEFAULT_LATENCY_BUCKETS)
                fam.children[items] = child
            return child

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._child(name, "counter", help, labels)  # type: ignore

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._child(name, "gauge", help, labels)  # type: ignore

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  ) -> Histogram:
        return self._child(name, "histogram", help, labels,  # type: ignore
                           buckets)

    # ------------------------------------------------------------ inspection
    def families(self) -> Iterable[_Family]:
        with self._lock:
            return list(self._families.values())

    def snapshot(self) -> dict:
        """Point-in-time value dump: ``{name: {"kind", "help", "values"}}``
        where ``values`` is a list of ``{"labels": {...}, ...}`` entries
        (counters/gauges carry ``value``; histograms carry ``sum``,
        ``count`` and per-bucket ``buckets`` keyed by upper bound, with
        ``"+Inf"`` last).  Plain dicts/floats only -- JSON-ready."""
        out: dict = {}
        for fam in self.families():
            values = []
            for items, child in sorted(fam.children.items()):
                entry: dict = {"labels": dict(items)}
                if isinstance(child, Histogram):
                    counts = child.bucket_counts()
                    with child._lock:
                        entry["sum"] = child._sum
                        entry["count"] = child._count
                    entry["buckets"] = {
                        **{repr(b): c for b, c in
                           zip(child.bounds, counts[:-1])},
                        "+Inf": counts[-1]}
                else:
                    entry["value"] = child.value  # type: ignore[attr-defined]
                values.append(entry)
            out[fam.name] = {"kind": fam.kind, "help": fam.help,
                             "values": values}
        return out

    def get_value(self, name: str,
                  labels: Optional[Dict[str, str]] = None) -> float:
        """Convenience for tests/tools: current value of a counter/gauge
        (0.0 when the family or child does not exist yet)."""
        items = _label_items(labels)
        with self._lock:
            fam = self._families.get(name)
            child = fam.children.get(items) if fam else None
        if child is None or isinstance(child, Histogram):
            return 0.0
        return child.value  # type: ignore[attr-defined]

    def reset(self) -> None:
        """Zero every instrument, keeping families and handles alive (a
        cached ``Counter`` reference stays valid across resets)."""
        for fam in self.families():
            with self._lock:
                children = list(fam.children.values())
            for child in children:
                child.reset()  # type: ignore[attr-defined]


# Process-default registry: all of the port's layers write here.  Kept
# module level (not per-session) so one snapshot sees encode, decode and
# the store at once.
_DEFAULT = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _DEFAULT


def set_enabled(flag: bool) -> bool:
    """Toggle the default registry's writes; returns the previous state."""
    prev = _DEFAULT.enabled
    _DEFAULT.enabled = bool(flag)
    return prev
