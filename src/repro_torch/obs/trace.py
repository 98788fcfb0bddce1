"""Span tracer: monotonic-clock timed spans with nesting and a ring.

``span("encode.flush", attrs={...})`` is a context manager: it stamps
``time.perf_counter()`` on entry and exit, records parent/child nesting
through a thread-local stack (each thread has its own span stack, so
pipeline worker threads nest correctly and independently), and appends
the finished span to a bounded ring buffer -- old spans fall off, the
tracer never grows without bound.  ``span(..., seconds=hist)`` also
observes the body's duration into a histogram child, whether or not the
tracer is recording.

Two record kinds share the ring:

* spans -- have a duration, a parent, and an ok/error status (an
  exception propagating out of the ``with`` body marks the span
  ``error`` and re-raises);
* events -- zero-duration structured facts (``event()``), e.g. the
  adaptive selector's mode switch (``encode.mode_switch``).

Exporters registered via ``add_exporter`` are called synchronously with
each finished record (Span instance); an exporter that raises is
dropped from the list rather than poisoning the hot path.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import TYPE_CHECKING, Callable, Dict, List, Optional

if TYPE_CHECKING:  # pragma: no cover
    from .metrics import Histogram

__all__ = ["Span", "SpanTracer", "tracer", "span", "event"]


class Span:
    __slots__ = ("name", "attrs", "span_id", "parent_id", "thread",
                 "start_s", "duration_s", "status", "kind")

    def __init__(self, name: str, attrs: Optional[Dict], span_id: int,
                 parent_id: Optional[int], thread: str, start_s: float,
                 duration_s: float, status: str, kind: str) -> None:
        self.name = name
        self.attrs = attrs or {}
        self.span_id = span_id
        self.parent_id = parent_id
        self.thread = thread
        self.start_s = start_s
        self.duration_s = duration_s
        self.status = status
        self.kind = kind

    def as_dict(self) -> dict:
        return {"name": self.name, "attrs": dict(self.attrs),
                "span_id": self.span_id, "parent_id": self.parent_id,
                "thread": self.thread, "start_s": self.start_s,
                "duration_s": self.duration_s, "status": self.status,
                "kind": self.kind}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, id={self.span_id}, "
                f"parent={self.parent_id}, {self.duration_s * 1e6:.1f}us, "
                f"{self.status})")


class SpanTracer:
    """Bounded-retention tracer; see the module docstring."""

    def __init__(self, capacity: int = 2048, enabled: bool = True) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.enabled = enabled
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._exporters: List[Callable[[Span], None]] = []

    # ------------------------------------------------------------- recording
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _finish(self, rec: Span) -> None:
        with self._lock:
            self._ring.append(rec)
            exporters = list(self._exporters)
        for fn in exporters:
            try:
                fn(rec)
            except Exception:
                self.remove_exporter(fn)

    @contextmanager
    def span(self, name: str, attrs: Optional[Dict] = None,
             seconds: Optional["Histogram"] = None):
        """Record ``name`` around the body.  ``seconds`` (a histogram
        child) observes the body's duration on normal exit, from the same
        two stamps as the span, and also while the tracer is disabled: the
        span is switched by ``enabled``, the histogram by its registry."""
        if not self.enabled:
            if seconds is None:
                yield None
                return
            start = time.perf_counter()
            yield None
            seconds.observe(time.perf_counter() - start)
            return
        stack = self._stack()
        parent_id = stack[-1] if stack else None
        span_id = next(self._ids)
        stack.append(span_id)
        start = time.perf_counter()
        status = "ok"
        try:
            yield span_id
        except BaseException:
            status = "error"
            raise
        finally:
            dur = time.perf_counter() - start
            stack.pop()
            self._finish(Span(name, attrs, span_id, parent_id,
                              threading.current_thread().name, start, dur,
                              status, "span"))
        if seconds is not None:
            seconds.observe(dur)

    def event(self, name: str, attrs: Optional[Dict] = None) -> None:
        """Zero-duration structured record, nested under the current span
        of the calling thread (if any)."""
        if not self.enabled:
            return
        stack = self._stack()
        self._finish(Span(name, attrs, next(self._ids),
                          stack[-1] if stack else None,
                          threading.current_thread().name,
                          time.perf_counter(), 0.0, "ok", "event"))

    # ------------------------------------------------------------- consumers
    def add_exporter(self, fn: Callable[[Span], None]) -> None:
        with self._lock:
            if fn not in self._exporters:
                self._exporters.append(fn)

    def remove_exporter(self, fn: Callable[[Span], None]) -> None:
        with self._lock:
            try:
                self._exporters.remove(fn)
            except ValueError:
                pass

    def records(self, name: Optional[str] = None,
                kind: Optional[str] = None) -> List[Span]:
        """Finished records, oldest first, optionally filtered."""
        with self._lock:
            recs = list(self._ring)
        if name is not None:
            recs = [r for r in recs if r.name == name]
        if kind is not None:
            recs = [r for r in recs if r.kind == kind]
        return recs

    def snapshot(self) -> List[dict]:
        return [r.as_dict() for r in self.records()]

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()


# Process-default tracer, sibling of the default metrics registry.
_DEFAULT = SpanTracer()


def tracer() -> SpanTracer:
    return _DEFAULT


def span(name: str, attrs: Optional[Dict] = None,
         seconds: Optional["Histogram"] = None):
    """``with obs.span("serve.plan", attrs={"seq": 3}): ...`` against the
    default tracer; ``seconds=`` also observes the body's duration into a
    histogram child (:meth:`SpanTracer.span`)."""
    return _DEFAULT.span(name, attrs, seconds)


def event(name: str, attrs: Optional[Dict] = None) -> None:
    _DEFAULT.event(name, attrs)
