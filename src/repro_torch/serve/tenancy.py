"""Multi-tenant state and admission control for the serving front end.

One :class:`Tenant` owns everything a paying client touches: its encode
streams (per-stream ``IdealemSession``, or slots in per-config
``StreamCoalescer`` cohorts for coalesced streams), its attached decode
containers behind one ``DecompressionService``, and its admission state
(stream/store counts, staged blocks, a bytes/s token bucket).

Admission is *typed*: every rejection raises a ``repro_torch.errors`` class
carrying the protocol code and HTTP status the front end answers with --
``QuotaExceededError`` (429: shed load), ``RateLimitedError`` (429 with
``retry_after_s``), ``OverloadedError`` (503: global backpressure, see
``repro_torch.serve.frontend``).  Nothing here touches a socket; the
module is synchronous and clock-injectable, so quota/backpressure
behaviour is unit testable without a server.

Every codec, coalescer and decode service of a tenant runs on the
tenant's ``device`` (default the card, raising without a GPU), an
in-process choice that never travels on the wire.  Decode services
default to ``decode_backend="cuda"`` (the reference's default is
``"auto"``, which stays selectable).  A coalescer's slot table starts at
one slot and doubles as streams join (the reference's starts at 64).

Streams come in two service shapes, chosen at open:

* ``coalesce=False`` (default): the stream owns an ``IdealemSession`` and
  each feed dispatches immediately -- segment bytes come back on the
  feed's own response, byte-identical to a direct session fed the same
  chunks (the loadgen's zero-byte-diff check).
* ``coalesce=True``: the stream occupies a slot in the tenant's
  per-config ``StreamCoalescer``; feeds stage host-side and the policy
  (or the front end's deadline tick) cuts one padded device batch for the
  whole cohort.  Segments produced by a background flush buffer on the
  stream until the client's next call collects them.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from .. import api
from ..device import resolve_device
from ..errors import (ApiError, NotFoundError, QuotaExceededError,
                      RateLimitedError)

__all__ = ["TenantQuota", "TokenBucket", "TenantStream", "Tenant",
           "TenantRegistry"]


@dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission limits.  ``None`` disables a limit."""

    max_streams: int = 64
    max_stores: int = 16
    max_staged_blocks: int = 4096        # staged in coalescer cohorts
    max_bytes_per_s: Optional[float] = None
    burst_bytes: Optional[float] = None  # bucket depth; default 1s of rate
    max_store_bytes: int = 64 << 20      # attached container size cap

    def to_json(self) -> dict:
        return {k: getattr(self, k) for k in (
            "max_streams", "max_stores", "max_staged_blocks",
            "max_bytes_per_s", "burst_bytes", "max_store_bytes")}

    @classmethod
    def from_json(cls, doc: dict) -> "TenantQuota":
        if not isinstance(doc, dict):
            raise ApiError("TenantQuota: expected object")
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(doc) - known
        if extra:
            raise ApiError(f"TenantQuota: unknown field(s) {sorted(extra)}")
        return cls(**doc)


class TokenBucket:
    """Bytes/s admission: a classic token bucket with injectable clock.

    ``take(n)`` either debits ``n`` tokens or raises
    :class:`RateLimitedError` with the refill time; a request larger than
    the bucket's depth can never succeed and raises
    :class:`QuotaExceededError` instead (retrying is futile)."""

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None):
        if rate <= 0:
            raise ValueError("token bucket rate must be positive")
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else float(rate)
        self._tokens = self.burst
        self._clock = clock if clock is not None else time.monotonic
        self._last = self._clock()

    def _refill(self) -> None:
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now

    def take(self, n: float) -> None:
        if n > self.burst:
            raise QuotaExceededError(
                f"request of {n:.0f} bytes exceeds the burst capacity "
                f"{self.burst:.0f} of this tenant's rate limit")
        self._refill()
        if self._tokens >= n:
            self._tokens -= n
            return
        raise RateLimitedError(
            f"bytes/s budget exhausted ({self.rate:.0f} B/s)",
            retry_after_s=(n - self._tokens) / self.rate)

    @property
    def tokens(self) -> float:
        self._refill()
        return self._tokens


@dataclass
class TenantStream:
    """One open wire stream: its session (direct) or coalescer slot
    (coalesced), plus segments a background flush produced that the
    client has not collected yet."""

    stream_id: str
    config: api.CodecConfig
    coalesced: bool
    session: object = None               # IdealemSession (direct streams)
    pending_segments: List[bytes] = field(default_factory=list)
    # cumulative stat snapshot at the last feed, for per-call deltas
    last_stats: tuple = (0, 0, 0, 0)     # blocks, hits, bytes_in, bytes_out

    def collect(self) -> bytes:
        """Drain segments produced since the client's last call (deadline
        flushes of coalesced streams land here)."""
        if not self.pending_segments:
            return b""
        out = b"".join(self.pending_segments)
        self.pending_segments.clear()
        return out


class Tenant:
    """All serving state of one tenant id; see the module docstring."""

    def __init__(self, tenant_id: str, quota: TenantQuota,
                 clock: Optional[Callable[[], float]] = None,
                 policy=None, decode_backend: str = "cuda", device=None):
        from .engine import FlushPolicy
        self.id = tenant_id
        self.device = resolve_device(device)
        self.quota = quota
        self._clock = clock if clock is not None else time.monotonic
        self.policy = policy if policy is not None else FlushPolicy()
        self.streams: Dict[str, TenantStream] = {}
        # one coalescer per codec config (a cohort shares one scan shape)
        self.coalescers: Dict[api.CodecConfig, object] = {}
        self._decomp = None
        self._decode_backend = decode_backend
        self.bucket = (TokenBucket(quota.max_bytes_per_s, quota.burst_bytes,
                                   clock=self._clock)
                       if quota.max_bytes_per_s else None)
        self.store_ids: Dict[str, int] = {}  # id -> container byte size

    # ----------------------------------------------------------- admission
    def admit_open_stream(self) -> None:
        if len(self.streams) >= self.quota.max_streams:
            raise QuotaExceededError(
                f"tenant {self.id!r} at max_streams="
                f"{self.quota.max_streams}")

    def admit_attach(self, nbytes: int) -> None:
        if len(self.store_ids) >= self.quota.max_stores:
            raise QuotaExceededError(
                f"tenant {self.id!r} at max_stores={self.quota.max_stores}")
        if nbytes > self.quota.max_store_bytes:
            raise QuotaExceededError(
                f"container of {nbytes} bytes exceeds max_store_bytes="
                f"{self.quota.max_store_bytes}")

    def admit_bytes(self, nbytes: int) -> None:
        if self.bucket is not None:
            self.bucket.take(float(nbytes))

    def admit_staged(self, add_blocks: int) -> None:
        if (self.staged_blocks + add_blocks) > self.quota.max_staged_blocks:
            raise QuotaExceededError(
                f"tenant {self.id!r} would stage "
                f"{self.staged_blocks + add_blocks} blocks "
                f"(max_staged_blocks={self.quota.max_staged_blocks})")

    @property
    def staged_blocks(self) -> int:
        """Whole blocks staged host-side across the tenant's coalescer
        cohorts, waiting for a flush -- the admission pressure signal."""
        return sum(c.pending_blocks for c in self.coalescers.values())

    # ------------------------------------------------------------ lifecycle
    def open_stream(self, stream_id: str, config: api.CodecConfig,
                    coalesce: bool = False) -> TenantStream:
        from ..core import IdealemCodec
        if stream_id in self.streams:
            raise ApiError(f"stream {stream_id!r} already open")
        self.admit_open_stream()
        if coalesce:
            if config.backend == "numpy":
                raise ApiError("coalesced streams batch on a device "
                               "backend; open with coalesce=false or a "
                               "torch/cuda config")
            coal = self.coalescers.get(config)
            if coal is None:
                from .compress import StreamCoalescer
                # one slot to start, doubled as streams join: a flush
                # scans every slot, and a tenant's cohort is usually far
                # smaller than the coalescer's default 64
                coal = StreamCoalescer(policy=self.policy, capacity=1,
                                       clock=self._clock, device=self.device,
                                       **config.kwargs())
                self.coalescers[config] = coal
            coal.open_stream(stream_id)
            st = TenantStream(stream_id, config, coalesced=True)
        else:
            codec = IdealemCodec.from_config(config, device=self.device)
            st = TenantStream(stream_id, config, coalesced=False,
                              session=codec.session())
        self.streams[stream_id] = st
        return st

    def stream(self, stream_id: str) -> TenantStream:
        st = self.streams.get(stream_id)
        if st is None:
            raise NotFoundError(
                f"tenant {self.id!r} has no open stream {stream_id!r}")
        return st

    def feed(self, req: api.CompressRequest) -> api.FeedResult:
        """Apply one wire feed; typed admission first, then the stream's
        service shape (direct dispatch vs coalesced staging)."""
        st = self.stream(req.stream_id)
        arr = np.asarray(req.samples)
        self.admit_bytes(arr.nbytes)
        if st.coalesced:
            coal = self.coalescers[st.config]
            staged = coal.staged_samples(req.stream_id)
            B = coal.block_size
            self.admit_staged((staged + len(arr)) // B - staged // B)
            flushed = coal.submit(req.stream_id, arr) or {}
            self._scatter_flush(flushed)
            seg = st.collect()
            return self._result(st, seg)
        seg = st.collect() + st.session.feed(arr)
        return self._result(st, seg)

    def close_stream(self, stream_id: str) -> api.FeedResult:
        st = self.stream(stream_id)
        if st.coalesced:
            coal = self.coalescers[st.config]
            seg = st.collect() + coal.close_stream(stream_id)
        else:
            seg = st.collect() + st.session.finish()
        res = self._result(st, seg, final=True)
        del self.streams[stream_id]
        return res

    def poll_flushes(self) -> int:
        """Deadline tick: run every coalescer's ``poll`` (the
        ``FlushPolicy.max_age_s`` trigger) and buffer resulting segments
        on their streams.  Returns the number of streams that flushed."""
        n = 0
        for coal in self.coalescers.values():
            flushed = coal.poll() or {}
            self._scatter_flush(flushed)
            n += len(flushed)
        return n

    def flush_all(self) -> int:
        """Force-flush every coalescer cohort (global backpressure relief
        and shutdown path)."""
        n = 0
        for coal in self.coalescers.values():
            flushed = coal.flush() or {}
            self._scatter_flush(flushed)
            n += len(flushed)
        return n

    def set_policy(self, policy) -> None:
        """Swap the flush policy on every owned coalescer and the decode
        service -- the control loop's actuation point."""
        self.policy = policy
        for coal in self.coalescers.values():
            coal.policy = policy
        if self._decomp is not None:
            self._decomp.policy = policy

    def _scatter_flush(self, flushed: Dict[str, bytes]) -> None:
        for sid, seg in flushed.items():
            if seg and sid in self.streams:
                self.streams[sid].pending_segments.append(seg)

    def _result(self, st: TenantStream, seg: bytes,
                final: bool = False) -> api.FeedResult:
        if st.coalesced:
            coal = self.coalescers[st.config]
            try:
                d = coal.stats(st.stream_id)
            except KeyError:  # already closed and retired
                d = coal.stats()
        else:
            d = st.session.stats.as_dict()
        now = (d["blocks"], d["hits"], d["bytes_in"], d["bytes_out"])
        delta = tuple(a - b for a, b in zip(now, st.last_stats))
        st.last_stats = now
        return api.FeedResult(
            stream_id=st.stream_id, segment=seg, blocks=delta[0],
            hits=delta[1], bytes_in=delta[2], bytes_out=delta[3],
            final=final)

    # ----------------------------------------------------------- decode side
    @property
    def decomp(self):
        if self._decomp is None:
            from .compress import DecompressionService
            self._decomp = DecompressionService(
                policy=self.policy, clock=self._clock,
                backend=self._decode_backend, device=self.device)
        return self._decomp

    def attach_store(self, store_id: str, blob: bytes, seed: int = 0) -> None:
        self.admit_attach(len(blob))
        self.decomp.attach(store_id, blob, seed=seed)
        self.store_ids[store_id] = len(blob)

    def detach_store(self, store_id: str) -> None:
        if store_id not in self.store_ids:
            raise NotFoundError(
                f"tenant {self.id!r} has no store {store_id!r}")
        self.decomp.detach(store_id)
        del self.store_ids[store_id]

    def close(self) -> None:
        """Retire the tenant: flush cohorts, close the decode pipeline."""
        for sid in list(self.streams):
            self.close_stream(sid)
        if self._decomp is not None:
            self._decomp.close()


class TenantRegistry:
    """Tenant table: default quota, per-tenant overrides, lazy creation.

    The front end asks :meth:`get` on every request; unknown tenants are
    created with the default quota (admission caps still bound them) --
    authentication is out of scope, isolation is the point."""

    def __init__(self, default_quota: Optional[TenantQuota] = None,
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 clock: Optional[Callable[[], float]] = None,
                 policy=None, decode_backend: str = "cuda",
                 max_tenants: int = 1024, device=None):
        self.default_quota = default_quota or TenantQuota()
        self.quotas = dict(quotas or {})
        self.tenants: Dict[str, Tenant] = {}
        self._clock = clock
        self._policy = policy
        self._decode_backend = decode_backend
        self.max_tenants = max_tenants
        self.device = resolve_device(device)

    def get(self, tenant_id: str, create: bool = True) -> Tenant:
        t = self.tenants.get(tenant_id)
        if t is None:
            if not create:
                raise NotFoundError(f"unknown tenant {tenant_id!r}")
            if len(self.tenants) >= self.max_tenants:
                raise QuotaExceededError(
                    f"server at max_tenants={self.max_tenants}")
            t = Tenant(tenant_id,
                       self.quotas.get(tenant_id, self.default_quota),
                       clock=self._clock, policy=self._policy,
                       decode_backend=self._decode_backend,
                       device=self.device)
            self.tenants[tenant_id] = t
        return t

    @property
    def staged_blocks(self) -> int:
        """Staged blocks across every tenant -- the global backpressure
        signal the front end maps to 503."""
        return sum(t.staged_blocks for t in self.tenants.values())

    def set_policy(self, policy) -> None:
        self._policy = policy
        for t in self.tenants.values():
            t.set_policy(policy)

    def poll_flushes(self) -> int:
        return sum(t.poll_flushes() for t in self.tenants.values())

    def close(self) -> None:
        for t in self.tenants.values():
            t.close()
