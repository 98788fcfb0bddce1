"""Measured-autotune machinery: remembering, guarding and persisting what a
timing probe measured.

  * :class:`MeasuredTuner` -- the thread-safe choice table: lazy load from
    an env-var-named path, versioned-document validation, atomic persist,
    probe/hit counts.  One instance per tuned subsystem (today the
    encoder's ``matcher="auto"``), each with its own env var and entry
    validator.
  * :func:`best_of` -- the timing primitive every probe uses: one warm-up
    call, then the best of N wall-clock runs.  A probe on the card makes
    each timed call end in a device sync.
  * :class:`repro_torch.errors.AutotuneCacheError` -- the typed failure for
    a corrupt or version-stale persisted cache.

The probe itself stays with its subsystem.  File format:
``{"version": N, "entries": {key: {..., "times_us": {...}}}}``.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, Dict, Optional

from .. import obs
from ..errors import AutotuneCacheError

__all__ = ["AutotuneCacheError", "MeasuredTuner", "best_of", "pow2_bucket"]

logger = logging.getLogger("repro_torch.core.tuning")


def best_of(fn: Callable[[], object], reps: int = 3) -> float:
    """Best-of-``reps`` wall-clock seconds after one warm-up call."""
    fn()  # warm-up: kernel builds, lazy module loads, caches
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def pow2_bucket(n: int, lo: int, hi: int) -> int:
    """Pow-2 size bucket of a workload dimension, clamped to [lo, hi] so
    the probe table stays small."""
    p = max(1, 1 << (int(max(1, n)) - 1).bit_length())
    return min(max(p, lo), hi)


class MeasuredTuner:
    """Versioned, persistable table of measured "auto" choices.

    ``env_var`` names the environment variable that (optionally) points at
    the JSON cache file; when set, the table is loaded lazily at first
    lookup and rewritten after each recorded probe.  ``validate_entry``
    rejects malformed entries on load; a stale ``version`` or corrupt file
    is discarded, never trusted.  Lookups and records hold an RLock.
    Probes (cold resolutions the caller measured) and hits (served from the
    table) are counted on the port's registry as
    ``repro_tuning_{probes,hits}_total{tuner=name}``; ``stats`` is a dict
    view of them.
    """

    def __init__(self, *, version: int, env_var: str,
                 validate_entry: Callable[[dict], bool],
                 log: Optional[logging.Logger] = None,
                 name: Optional[str] = None):
        self.version = version
        self.env_var = env_var
        self.name = name if name is not None else env_var.lower()
        self._validate_entry = validate_entry
        self._log = log if log is not None else logger
        self._entries: Dict[str, dict] = {}
        self._loaded = False
        self.lock = threading.RLock()
        reg = obs.registry()
        self._probes = reg.counter(
            "repro_tuning_probes_total",
            "cold auto resolutions measured by a timing probe",
            labels={"tuner": self.name})
        self._hits = reg.counter(
            "repro_tuning_hits_total",
            "auto resolutions served from the recorded table",
            labels={"tuner": self.name})

    @property
    def stats(self) -> Dict[str, int]:
        """``{"probes": int, "hits": int}`` (a snapshot)."""
        return {"probes": int(self._probes.value),
                "hits": int(self._hits.value)}

    # ------------------------------------------------------------ persistence
    def _path(self) -> Optional[str]:
        return os.environ.get(self.env_var) or None

    def _validate_doc(self, doc) -> dict:
        if not isinstance(doc, dict):
            raise AutotuneCacheError("autotune cache is not a JSON object")
        if doc.get("version") != self.version:
            raise AutotuneCacheError(
                f"autotune cache version {doc.get('version')!r} != "
                f"{self.version}: stale cache, re-probe")
        entries = doc.get("entries")
        if not isinstance(entries, dict):
            raise AutotuneCacheError("autotune cache has no 'entries' object")
        for key, ent in entries.items():
            if (not isinstance(ent, dict)
                    or not isinstance(ent.get("times_us"), dict)
                    or not self._validate_entry(ent)):
                raise AutotuneCacheError(f"malformed autotune entry {key!r}")
        return entries

    def load(self, path: str, strict: bool = True) -> int:
        """Load persisted choices; returns the entry count.

        ``strict=True`` raises :class:`AutotuneCacheError` on a corrupt or
        version-stale file; ``strict=False`` logs, discards, and leaves the
        table cold so combinations are re-probed."""
        with self.lock:
            self._loaded = True
            try:
                with open(path, "r", encoding="utf-8") as f:
                    doc = json.load(f)
                entries = self._validate_doc(doc)
            except AutotuneCacheError:
                if strict:
                    raise
                self._log.warning("discarding invalid autotune cache %s "
                                  "(re-probing)", path)
                return 0
            except (OSError, ValueError) as e:
                if strict:
                    raise AutotuneCacheError(
                        f"unreadable autotune cache: {e}") from e
                self._log.warning("discarding unreadable autotune cache %s "
                                  "(%s)", path, e)
                return 0
            self._entries.update(entries)
            return len(entries)

    def save(self, path: str) -> None:
        """Persist the in-memory choices as the versioned JSON cache
        (atomic replace, so a racing reader never sees a half-written
        file)."""
        with self.lock:
            doc = {"version": self.version, "entries": dict(self._entries)}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)

    def reset(self) -> None:
        """Forget every choice (and the lazy disk load): the next lookup
        misses and the caller re-probes."""
        with self.lock:
            self._entries.clear()
            self._loaded = False
            self._probes.reset()
            self._hits.reset()

    # ---------------------------------------------------------------- lookups
    def _ensure_loaded(self) -> None:
        if not self._loaded:
            self._loaded = True
            path = self._path()
            if path and os.path.exists(path):
                self.load(path, strict=False)

    def cached(self, key: str) -> bool:
        """Whether ``key`` would resolve from the table (True) or force a
        timing probe (False)."""
        with self.lock:
            self._ensure_loaded()
            return key in self._entries

    def record(self, key: str, entry: dict) -> dict:
        """Store a freshly probed entry (counted as a probe) and persist it
        when the env var names a path.  Persisting is an optimization: an
        unwritable path is logged and the in-memory choice stands."""
        with self.lock:
            self._entries[key] = entry
            self._probes.inc()
        path = self._path()
        if path:
            try:
                self.save(path)
            except OSError as e:
                self._log.warning("could not persist autotune cache to %s "
                                  "(%s); continuing in-memory", path, e)
        return entry

    def resolve(self, key: str, probe: Callable[[], dict]) -> dict:
        """Serve ``key`` from the table or run ``probe`` once under the
        lock and record its entry (two threads racing a cold key must not
        both measure)."""
        with self.lock:
            self._ensure_loaded()
            ent = self._entries.get(key)
            if ent is not None:
                self._hits.inc()
                return ent
            return self.record(key, probe())

    def choices(self, field: str) -> dict:
        """Current routing table: key -> the named entry field."""
        with self.lock:
            return {k: v[field] for k, v in sorted(self._entries.items())}
