"""Stage execution for the pipelined serving decode path.

A ``DecompressionService`` flush is four explicit stages:

    plan        host   seek + walk the covering chunks  (store.plan_windows)
    gather      host   one shared byte gather + padding (store.gather_parts,
                       decode.pad_parts)
    reconstruct device the unified engine dispatch      (decode.reconstruct)
    emit        host   slice answers per request, account stats/errors

Plan and gather run in the caller's thread at flush time; reconstruct is
handed to a *stage executor*; emit runs in the caller's thread when the
batch is collected.  ``StagePipeline`` bounds how many reconstruct batches
may be in flight (``FlushPolicy.pipeline_depth``): with depth 1 the
executor resolves inline and a flush returns its own answers -- the
alternating path.  With depth 2 the service plans/gathers batch N+1 on
the host while the executor's worker thread reconstructs batch N, and a
flush returns the answers of the batch that just *completed*.

On the card the worker thread launches on its current CUDA stream, and
every reconstruct ends in a ``.cpu()`` copy that synchronizes that stream:
no tensor crosses threads, only host arrays do.

Executors are injectable (``DecompressionService(executor=...)``), so
tests can substitute a deterministic fake whose futures run lazily at
collection time and prove the stage ordering without real threads.  Any
object with ``submit(fn, *args) -> future`` (future: ``result()``) and
``shutdown()`` is an executor.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, List, Optional, Tuple

from .. import obs

__all__ = ["StageFuture", "SyncExecutor", "ThreadStageExecutor",
           "StagePipeline"]

# A batch whose reconstruct stage was *lost* (the stage raised, or the
# executor died under it).  ``last_errors`` on the service tells the
# operator which requests; this counter (on the port's registry) makes the
# event scrapeable.
_M_STAGE_ERRORS = obs.registry().counter(
    "repro_serve_stage_errors_total",
    "in-flight batches collected with a stage exception")


class StageFuture:
    """Minimal completed-or-failed future: ``result()`` returns the stage's
    value or re-raises its exception."""

    __slots__ = ("_value", "_exc", "_event")

    def __init__(self):
        self._value = None
        self._exc: Optional[BaseException] = None
        self._event = threading.Event()

    def set_result(self, value) -> None:
        self._value = value
        self._event.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self):
        self._event.wait()
        if self._exc is not None:
            raise self._exc
        return self._value


class SyncExecutor:
    """Inline executor: the stage runs in ``submit`` itself.  Depth-1
    pipelines use this -- the classic alternating flush."""

    def submit(self, fn: Callable, *args) -> StageFuture:
        fut = StageFuture()
        try:
            fut.set_result(fn(*args))
        except BaseException as e:  # delivered at result(), like a thread
            fut.set_exception(e)
        return fut

    def shutdown(self) -> None:
        pass


class ThreadStageExecutor:
    """One daemon worker thread draining a FIFO of stages.

    A single worker keeps device dispatch serialized (batches never race
    for the accelerator) while the caller thread stays free to plan and
    gather the next batch -- double-buffering, not fan-out.

    ``shutdown()`` is idempotent and safe after a worker death:
    ``DecompressionService.close()`` may run it twice (its own ``close``
    plus a ``with``-exit) or after the worker thread is already gone, and
    must never block or raise.  ``submit`` after shutdown -- or onto a
    dead worker -- delivers a failed future instead of enqueueing work
    nobody will run (a silent hang at ``result()``)."""

    def __init__(self, name: str = "repro-torch-decode-pipeline"):
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._shutdown = False
        self._thread = threading.Thread(target=self._worker, name=name,
                                        daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            fut, fn, args = item
            try:
                fut.set_result(fn(*args))
            except BaseException as e:
                fut.set_exception(e)

    @property
    def alive(self) -> bool:
        return not self._shutdown and self._thread.is_alive()

    def submit(self, fn: Callable, *args) -> StageFuture:
        fut = StageFuture()
        if not self.alive:
            fut.set_exception(RuntimeError(
                "ThreadStageExecutor is shut down (or its worker died); "
                "stage not submitted"))
            return fut
        self._queue.put((fut, fn, args))
        return fut

    def shutdown(self) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        if self._thread.is_alive():
            self._queue.put(None)


class StagePipeline:
    """Bounded window of in-flight reconstruct batches.

    ``push(meta, fn, *args)`` submits one batch's reconstruct stage and
    then collects (blocking, oldest first) until at most ``depth - 1``
    batches remain in flight -- so depth 1 collects the batch it just
    pushed, and depth 2 returns the *previous* batch while the new one
    runs.  ``drain()`` collects everything still in flight (shutdown, or
    a caller that wants answers now).  Collected batches come back as
    ``(meta, value, exc)`` -- a stage that raised is delivered, not
    swallowed, so the service can quarantine its requests.
    """

    def __init__(self, executor, depth: int = 1):
        if depth < 1:
            raise ValueError("pipeline depth must be >= 1")
        self.executor = executor
        self.depth = depth
        self._inflight: List[Tuple[Any, StageFuture]] = []

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    def metas(self) -> List[Any]:
        """Metas of the batches currently in flight, oldest first (the
        service uses this to know which request ids are still live)."""
        return [meta for meta, _ in self._inflight]

    def push(self, meta, fn: Callable, *args
             ) -> List[Tuple[Any, Any, Optional[BaseException]]]:
        self._inflight.append((meta, self.executor.submit(fn, *args)))
        out = []
        while len(self._inflight) > self.depth - 1:
            out.append(self._collect())
        out.extend(self.collect_ready())  # finished early: deliver now
        return out

    def collect_ready(self) -> List[Tuple[Any, Any, Optional[BaseException]]]:
        """Collect batches that have ALREADY completed, oldest first,
        without blocking (collection is in-order: a finished batch behind
        an unfinished one waits so answers never reorder).  Futures
        without a ``done()`` (minimal injected fakes) are treated as not
        ready -- they surface at the depth window or ``drain()``."""
        out = []
        while (self._inflight
               and getattr(self._inflight[0][1], "done", lambda: False)()):
            out.append(self._collect())
        return out

    def drain(self) -> List[Tuple[Any, Any, Optional[BaseException]]]:
        out = []
        while self._inflight:
            out.append(self._collect())
        return out

    def _collect(self) -> Tuple[Any, Any, Optional[BaseException]]:
        meta, fut = self._inflight.pop(0)
        try:
            return meta, fut.result(), None
        except Exception as e:
            _M_STAGE_ERRORS.inc()
            return meta, None, e
