"""Compression as a service: the IDEALEM endpoints of the serving layer.

``CompressionService`` is the telemetry-ingest endpoint: many concurrent
client streams, each an ``IdealemSession`` whose FIFO dictionary survives
between requests, so hit rates match one-shot compression however the
stream is chunked over the wire.

  svc = CompressionService(mode="std", block_size=32, num_dict=255)
  svc.open_stream("pmu-7")            # or channels=C for batched sensors
  seg = svc.feed("pmu-7", chunk)      # append-mode segment bytes (may be b"")
  seg = svc.close_stream("pmu-7")     # final segment (tail samples)

Concatenating every returned segment yields a stream that
``repro_torch.core.stream.decode_stream`` decodes identically to a
one-shot ``IdealemCodec.encode`` of the whole signal.

``CompressionService`` runs one device scan per feed per stream -- right
for few fat streams.  ``StreamCoalescer`` is the heavy-traffic endpoint:
it stages ``submit()`` payloads of many live streams on the host and, when
its ``FlushPolicy`` trips, cuts ONE padded device batch (streams stacked on
the channel axis, ragged block counts masked) and scatters the encoded
segments back per stream.  On ``backend="cuda"`` a flush is one launch of
the fused scan K1 (``csrc/encode_step.cu``); an adaptive codec's flush is
one launch of K1 with its ``chan`` operand.  A residual or delta flush of
float64 streams without a plan stages the raw blocks and transforms the
whole batch on the device (``core/transforms.py``'s tensor twins, bitwise
the host's), bringing the payload back in the flush's copy out.  With an
encode plan (``StreamCoalescer(plan=...)``) the slot axis is split over
the plan's devices: one such launch a shard, or, for a plan that splits
the dictionary rows, one K3 launch a shard a block step.  Per-stream
bytes are those the per-stream service would emit.

``DecompressionService`` is the symmetric read path: range requests
against packed containers (``repro_torch.store``), answered from an LRU of
parsed chunks, with concurrent requests coalesced into one padded
reconstruct per compatible group and flush -- the same ``FlushPolicy``
(count, block and ``max_age_s`` triggers) on both sides of the codec.  On
a delta container with ``backend="cuda"`` a group's reconstruct is one
launch of K2 (``csrc/seq_cumsum.cu``).

The services count into the port's registry (``repro_torch.obs``) under
the reference package's metric names.
"""
from __future__ import annotations

import functools
import time
from collections import OrderedDict
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from .. import api, obs
from ..core import IdealemCodec
from ..core import decode as decode_mod
from ..core.encoder import (encode_decisions_batched, init_sharded_state,
                            init_state, reset_channel)
from ..core.session import (_M_TRANSFORM, IdealemSession, MixedCohort,
                            SessionStats, _mixed_matcher_name, _planned_scan)
from ..core.transforms import delta_forward, residual_forward
from ..device import resolve_device
from ..errors import ApiError
from ..store import (Container, decode_channels, decode_range, gather_parts,
                     parse_chunk, plan_windows)
from .engine import FlushPolicy
from .pipeline import StagePipeline, SyncExecutor, ThreadStageExecutor

__all__ = ["CompressionService", "StreamCoalescer", "DecompressionService"]

# ---------------------------------------------------------------- telemetry
# Process-wide aggregates across service instances; per-instance detail
# stays on each service's ``stats``, which these mirror.
_M_STAGE_SECONDS = {
    stage: obs.registry().histogram(
        "repro_serve_stage_seconds",
        "pipelined decode stage latency per flush batch",
        labels={"stage": stage})
    for stage in ("plan", "gather", "reconstruct", "emit")
}
_M_SERVE = {
    key: obs.registry().counter(f"repro_serve_{key}_total", help_text)
    for key, help_text in {
        "requests": "range requests answered",
        "blocks_out": "blocks reconstructed and handed out",
        "flushes": "decode flush batches cut",
        "failed_requests": "requests quarantined into last_errors",
        "cache_hits": "parsed-segment LRU hits",
        "cache_misses": "parsed-segment LRU misses (chunk walked)",
        "dispatches": "reconstruct engine dispatches",
    }.items()
}
_M_INFLIGHT = obs.registry().gauge(
    "repro_serve_inflight",
    "reconstruct batches in flight (most recent pipeline activity)")
_M_FLUSH_AGE = obs.registry().histogram(
    "repro_serve_flush_age_seconds",
    "age of the oldest pending request when its batch was cut")
_M_ENC_FLUSHES = obs.registry().counter(
    "repro_encode_flushes_total", "coalescer device flush batches")
_M_ENC_FLUSH_SECONDS = obs.registry().histogram(
    "repro_encode_flush_seconds", "coalescer flush wall time")
_M_ENC_FLUSH_BLOCKS = obs.registry().histogram(
    "repro_encode_flush_blocks", "blocks encoded per coalescer flush",
    buckets=tuple(float(1 << p) for p in range(0, 17, 2)))
_M_ENC_FLUSH_STEP = {
    step: obs.registry().histogram(
        "repro_encode_flush_step_seconds",
        "coalescer flush wall time by step, each over the whole flush",
        labels={"step": step})
    for step in ("take", "prepare", "stage", "h2d", "scan", "d2h", "commit")
}
_M_ENC_FLUSH_CELLS = obs.registry().counter(
    "repro_encode_flush_cells_total",
    "block cells of the coalescer's padded scans (slots x padded blocks)")
_M_STREAMS_OPEN = {
    kind: obs.registry().gauge(
        "repro_encode_streams_open", "open encode streams",
        labels={"kind": kind})
    for kind in ("session", "coalesced")
}


def _staged(stage: str, seq: int, **attrs):
    """Span ``serve.<stage>`` (attrs ``seq`` and ``attrs``) around one
    pipeline stage body; its duration goes into the stage-latency
    histogram when the body returns."""
    return obs.span(f"serve.{stage}", attrs={"seq": seq, **attrs},
                    seconds=_M_STAGE_SECONDS[stage])


def _step(step: str):
    """Span ``encode.<step>`` inside ``encode.flush`` and its
    ``repro_encode_flush_step_seconds`` child, around one step of a
    coalescer flush taken over all of the flush's streams at once."""
    return obs.span(f"encode.{step}", seconds=_M_ENC_FLUSH_STEP[step])


class _PlannedStore(NamedTuple):
    """One store's share of a flush batch after the *plan* stage."""

    store_id: str
    pkey: tuple                    # (mode, block_size, dtype str, range, eb)
    requests: list                 # [(rid, channel, start, stop), ...]
    ranges: list                   # [(channel, start, stop), ...]
    header: object
    windows: list


class _Unit(NamedTuple):
    """One reconstruct dispatch after the *gather* stage: a padded plan
    plus how to slice each request back out at *emit*."""

    backend: str                   # resolved concrete backend
    block_size: int
    items: list                    # [(rid, n_blocks), ...] in plan order
    plan: object                   # decode.DecodePlan
    nbm: int                       # padded per-request block count


def _fold_stats(agg: SessionStats, st: SessionStats) -> None:
    agg.blocks += st.blocks
    agg.hits += st.hits
    agg.segments += st.segments
    agg.bytes_in += st.bytes_in
    agg.bytes_out += st.bytes_out


class CompressionService:
    """Multi-stream host endpoint over persistent ``IdealemSession`` state.
    Codec keyword defaults (``device`` included) apply to every stream."""

    def __init__(self, **codec_defaults):
        self._defaults = codec_defaults
        self._streams: Dict[str, IdealemSession] = {}
        self._closed: Dict[str, Union[SessionStats, List[SessionStats]]] = {}
        # closed streams whose id was reopened: per-id stats are replaced,
        # but their traffic stays in the service aggregate
        self._retired = SessionStats()

    @property
    def active_streams(self) -> List[str]:
        return sorted(self._streams)

    def open_stream(self, stream_id: str, channels: Optional[int] = None,
                    dtype=np.float64, container: bool = False,
                    **codec_overrides) -> None:
        """Register a stream; codec kwargs override the service defaults.
        ``container=True`` makes ``close_stream`` return the whole stream
        as one indexed random-access container (``repro_torch.store``)."""
        if stream_id in self._streams:
            raise KeyError(f"stream {stream_id!r} already open")
        codec = IdealemCodec(**{**self._defaults, **codec_overrides})
        self._streams[stream_id] = codec.session(channels=channels,
                                                 dtype=dtype,
                                                 container=container)
        _M_STREAMS_OPEN["session"].inc()
        old = self._closed.pop(stream_id, None)
        if old is not None:
            for one in (old if isinstance(old, list) else [old]):
                _fold_stats(self._retired, one)

    def feed(self, stream_id: str, chunk) -> Union[bytes, List[bytes]]:
        """Compress the next chunk of an open stream; returns segment bytes
        (one per channel for batched streams)."""
        return self._session(stream_id).feed(chunk)

    def close_stream(self, stream_id: str) -> Union[bytes, List[bytes]]:
        """Finalize a stream: the tail-carrying final segment (or, for
        ``container=True`` streams, the packed container); the session is
        retired and its stats stay queryable."""
        sess = self._session(stream_id)
        seg = sess.finish()
        self._closed[stream_id] = sess.stats
        del self._streams[stream_id]
        _M_STREAMS_OPEN["session"].dec()
        return seg

    def handle(self, req):
        """Serve one wire-typed :class:`repro_torch.api.CompressRequest`
        and return its :class:`repro_torch.api.FeedResult` with per-call
        stat deltas.  Single-channel streams only (the wire shape)."""
        sess = self._session(req.stream_id)
        st = sess.stats
        if isinstance(st, list):
            raise ApiError(
                "handle() serves single-channel streams; use feed() for "
                "batched multi-channel sessions")
        before = (st.blocks, st.hits, st.bytes_in, st.bytes_out)
        seg = sess.feed(np.asarray(req.samples))
        after = (st.blocks, st.hits, st.bytes_in, st.bytes_out)
        d = tuple(a - b for a, b in zip(after, before))
        return api.FeedResult(stream_id=req.stream_id, segment=seg,
                              blocks=d[0], hits=d[1], bytes_in=d[2],
                              bytes_out=d[3])

    def stats(self, stream_id: Optional[str] = None) -> dict:
        """Per-stream stats dict, or the aggregate over all streams."""
        if stream_id is not None:
            st = (self._streams[stream_id].stats
                  if stream_id in self._streams else self._closed[stream_id])
            if isinstance(st, list):
                return {"channels": [one.as_dict() for one in st]}
            return st.as_dict()
        agg = SessionStats()
        _fold_stats(agg, self._retired)
        for st in list(self._closed.values()) + [
                s.stats for s in self._streams.values()]:
            for one in (st if isinstance(st, list) else [st]):
                _fold_stats(agg, one)
        return agg.as_dict()

    def _session(self, stream_id: str) -> IdealemSession:
        try:
            return self._streams[stream_id]
        except KeyError:
            raise KeyError(f"stream {stream_id!r} is not open") from None


class StreamCoalescer:
    """Batch many live streams into one padded device encode per flush.

    Every open stream owns a channel slot of one batched ``DictState``
    carry on the codec's device (a recycled slot is reset in place, so it
    decides like a fresh dictionary).  ``submit`` only stages samples on
    the host; the device is touched once per ``flush`` -- triggered by the
    ``FlushPolicy`` or called explicitly -- which cuts a single
    ``(capacity, nb_pad, n)`` scan with ragged streams padded and masked,
    then commits each stream's segment.

    One codec configuration per coalescer.  Adaptive codecs coalesce too:
    each stream's selector may change its mode and threshold, and the
    flush decides the whole cohort in one masked mixed-mode scan
    (``MixedCohort``) -- ``reference`` or ``fused`` matchers only.

    ``plan`` (``repro_torch.launch.encode_plan.EncodePlan``) splits the
    slot axis over its devices, each shard's carry resident on its device;
    the capacity is then pinned to the plan's padded channel count.
    Without a plan the slot table doubles on demand.  ``block_bucket``
    rounds the padded scan length up so recurring traffic reuses a few
    shapes.
    """

    def __init__(self, policy: Optional[FlushPolicy] = None, plan=None,
                 capacity: int = 64, block_bucket: int = 32,
                 dtype=np.float64, clock: Optional[Callable[[], float]] = None,
                 **codec_kwargs):
        self._codec = IdealemCodec(**codec_kwargs)
        if self._codec.backend == "numpy":
            raise ValueError("StreamCoalescer batches on device; use "
                             "CompressionService for the numpy backend")
        self._adaptive = bool(self._codec.adaptive)
        if self._adaptive and _mixed_matcher_name(self._codec) is None:
            raise ValueError(
                "adaptive coalescing needs the reference or fused matcher "
                "(the batched mixed scan has no masked variant of "
                f"{self._codec.matcher!r})")
        if plan is not None and plan.channels != plan.padded_channels:
            raise ValueError("coalescer plans must be made for a padded "
                             "channel count (channels % devices == 0)")
        if self._adaptive and plan is not None and plan.dict_shards > 1:
            raise ValueError("adaptive coalescing shards the slot axis "
                             "only; build the plan with dict_shards=1")
        self.policy = policy or FlushPolicy()
        self.plan = plan
        self._capacity = plan.padded_channels if plan is not None else capacity
        self._bucket = max(1, block_bucket)
        self._dtype = np.dtype(dtype)
        # residual and delta float64 flushes without a plan transform on
        # the device: std has nothing to transform, a planned flush copies
        # each shard's slots to its own device, and another stream dtype
        # keeps the host's NumPy arithmetic
        self._device_transform = (plan is None
                                  and self._codec.mode != "std"
                                  and self._dtype == np.float64)
        self._sessions: Dict[str, IdealemSession] = {}
        self._slots: Dict[str, int] = {}
        self._free = list(range(self._capacity))[::-1]  # pop() -> lowest
        self._pending: Dict[str, List[np.ndarray]] = {}
        # per-stream staged samples (carried tail + pending chunks) and the
        # aggregate flush-pressure counters, kept incrementally so submit()
        # stays O(1) however many streams are open
        self._buffered: Dict[str, int] = {}
        self._ready_streams = 0
        self._ready_blocks = 0
        self._state = None  # batched DictState over capacity slots (static)
        self._mixed = None  # MixedCohort over capacity slots (adaptive)
        self._closed: Dict[str, SessionStats] = {}
        self._retired = SessionStats()  # closed ids later reopened
        # deadline trigger: per-stream time of the oldest staged payload,
        # on an injectable clock
        self._clock = clock if clock is not None else time.monotonic
        self._staged_ts: Dict[str, float] = {}

    @property
    def active_streams(self) -> List[str]:
        return sorted(self._sessions)

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def block_size(self) -> int:
        return self._codec.block_size

    @property
    def pending_blocks(self) -> int:
        """Whole blocks staged on the host awaiting a flush, summed over
        open streams (an admission pressure signal)."""
        return self._ready_blocks

    def staged_samples(self, stream_id: str) -> int:
        """Samples staged for one stream (tail included), on the host."""
        if stream_id not in self._sessions:
            raise KeyError(f"stream {stream_id!r} is not open")
        return self._buffered[stream_id]

    # ------------------------------------------------------------- lifecycle
    def open_stream(self, stream_id: str) -> None:
        if stream_id in self._sessions:
            raise KeyError(f"stream {stream_id!r} already open")
        if not self._free:
            self._grow()
        slot = self._free.pop()
        self._reset_slot(slot)
        self._sessions[stream_id] = self._codec.session(dtype=self._dtype)
        self._slots[stream_id] = slot
        self._pending[stream_id] = []
        self._buffered[stream_id] = 0
        _M_STREAMS_OPEN["coalesced"].inc()
        old = self._closed.pop(stream_id, None)
        if old is not None:
            _fold_stats(self._retired, old)

    def submit(self, stream_id: str, chunk) -> Optional[Dict[str, bytes]]:
        """Stage a chunk; returns the flush result when the policy trips
        (segments of every flushed stream, by stream id), else ``None``.
        No device work happens before the flush."""
        if stream_id not in self._sessions:
            raise KeyError(f"stream {stream_id!r} is not open")
        arr = np.asarray(chunk)
        if arr.ndim != 1:
            raise ValueError("coalesced streams feed 1-D chunks")
        self._pending[stream_id].append(arr)
        if len(arr) and stream_id not in self._staged_ts:
            self._staged_ts[stream_id] = self._clock()
        B = self._codec.block_size
        old = self._buffered[stream_id]
        new = old + len(arr)
        self._buffered[stream_id] = new
        self._ready_blocks += new // B - old // B
        if old // B == 0 and new // B > 0:
            self._ready_streams += 1
        if self.policy.should_flush(self._ready_streams, self._ready_blocks,
                                    self._age()):
            return self.flush()
        return None

    def poll(self) -> Optional[Dict[str, bytes]]:
        """Deadline tick for the ``max_age_s`` trigger: flushes (and
        returns the segments) iff the policy's deadline has expired."""
        if self.policy.should_flush(self._ready_streams, self._ready_blocks,
                                    self._age()):
            return self.flush()
        return None

    def flush(self) -> Dict[str, bytes]:
        """Encode all pending blocks in one padded device batch and return
        each flushed stream's segment bytes."""
        return self._flush(list(self._sessions))

    def close_stream(self, stream_id: str) -> bytes:
        """Flush the stream's pending samples, emit its tail-carrying final
        segment, and recycle its slot."""
        sess = self._sessions.get(stream_id)
        if sess is None:
            raise KeyError(f"stream {stream_id!r} is not open")
        flushed = self._flush([stream_id]).get(stream_id, b"")
        final = sess.finish()
        self._closed[stream_id] = sess.stats
        self._free.append(self._slots.pop(stream_id))
        del self._sessions[stream_id]
        del self._pending[stream_id]
        del self._buffered[stream_id]
        self._staged_ts.pop(stream_id, None)
        _M_STREAMS_OPEN["coalesced"].dec()
        return flushed + final

    def stats(self, stream_id: Optional[str] = None) -> dict:
        if stream_id is not None:
            st = (self._sessions[stream_id].stats
                  if stream_id in self._sessions
                  else self._closed[stream_id])
            return st.as_dict()
        agg = SessionStats()
        _fold_stats(agg, self._retired)
        for st in list(self._closed.values()) + [
                s.stats for s in self._sessions.values()]:
            _fold_stats(agg, st)
        return agg.as_dict()

    # ------------------------------------------------------------- internals
    def _age(self) -> Optional[float]:
        if not self._staged_ts:
            return None
        return self._clock() - min(self._staged_ts.values())

    def _reset_slot(self, slot: int) -> None:
        """A recycled slot must look like a fresh dictionary: clearing its
        rows' validity and its FIFO counter in place on the device carry
        suffices (invalid rows are never consulted, inserts overwrite)."""
        if self._mixed is not None:
            self._mixed.reset_lane(slot)
        if self._state is not None:
            reset_channel(self._state, slot)

    def _grow(self) -> None:
        """Double the slot axis; the new slots start empty."""
        if self.plan is not None:
            raise RuntimeError(
                f"coalescer at plan-pinned capacity {self._capacity}")
        old = self._capacity
        self._capacity = old * 2
        self._free.extend(range(self._capacity - 1, old - 1, -1))
        if self._mixed is not None:
            self._mixed.grow(self._capacity)
        if self._state is not None:
            # every field, the empty (C, 0, n) raw rows included when the
            # error bound is off: (C, 0, n) -> (2C, 0, n)
            self._state = type(self._state)(*(
                torch.cat([f, f.new_zeros((old,) + f.shape[1:])])
                for f in self._state))

    def _take(self, stream_ids: List[str]) -> List[Tuple[str, np.ndarray]]:
        """Pop every listed stream's staged chunks (streams with nothing
        staged keep their sub-block tail) and settle the pressure
        counters."""
        B = self._codec.block_size
        taken = []
        for sid in stream_ids:
            chunks = self._pending[sid]
            if not chunks:
                continue
            self._pending[sid] = []
            self._staged_ts.pop(sid, None)
            ready = self._buffered[sid] // B
            self._buffered[sid] %= B  # the tail carries over
            self._ready_blocks -= ready
            if ready:
                self._ready_streams -= 1
            taken.append((sid, np.concatenate(chunks)))
        return taken

    def _nb_pad(self, prepared) -> int:
        nb_max = max(p.nb for p in prepared.values())
        return -(-nb_max // self._bucket) * self._bucket

    def _flush(self, stream_ids: List[str]) -> Dict[str, bytes]:
        t0 = time.perf_counter()
        with obs.span("encode.flush", attrs={"streams": len(stream_ids)}):
            out = self._flush_impl(stream_ids)
        if out:
            _M_ENC_FLUSHES.inc()
            _M_ENC_FLUSH_SECONDS.observe(time.perf_counter() - t0)
        return out

    def _host_empty(self, shape) -> torch.Tensor:
        """An uninitialised float64 host tensor, page-locked when the
        codec's device is a card: the caching host allocator hands the same
        blocks back flush after flush, and the card copies to and from
        them at DMA speed."""
        return torch.empty(shape, dtype=torch.float64, pin_memory=(
            self._codec.torch_device.type == "cuda"))

    def _stage(self, prepared, nb_pad: int, raw: bool):
        """The flush's padded host batch and its mask: each stream's raw
        float64 blocks ``(capacity, nb_pad, B)`` (``raw``; every element
        written once, the rows past a stream's and the slots without
        blocks as zeros), else its payloads ``(capacity, nb_pad, n_lem)``
        as float32, the scan's input."""
        valid = np.zeros((self._capacity, nb_pad), dtype=bool)
        if not raw:
            batch = np.zeros((self._capacity, nb_pad, self._codec._lem_n()),
                             dtype=np.float32)
            for sid, prep in prepared.items():
                slot = self._slots[sid]
                batch[slot, :prep.nb] = prep.payloads[0]
                valid[slot, :prep.nb] = True
            return batch, valid
        batch = self._host_empty(
            (self._capacity, nb_pad, self._codec.block_size)).numpy()
        for sid, prep in prepared.items():
            slot = self._slots[sid]
            batch[slot, :prep.nb] = prep.blocks[0]
            batch[slot, prep.nb:] = 0
            valid[slot, :prep.nb] = True
        batch[~valid.any(axis=1)] = 0
        return batch, valid

    def _redo_nan_blocks(self, payload, blocks, nan_rows) -> None:
        """A NaN's bits are those of the arithmetic that made it (the
        device's, or a vectorised ``fmod``'s), not NumPy's: the blocks whose
        device payload holds a NaN are transformed again on the host, in
        place, so the stream bytes are the host path's.  (The scan's
        decisions do not depend on a NaN's bits.)"""
        rows = np.flatnonzero(nan_rows)
        if len(rows):
            payload[rows] = self._codec._transform(blocks[rows])[0]
            _M_TRANSFORM["host"].inc(len(rows))

    def _flush_impl(self, stream_ids: List[str]) -> Dict[str, bytes]:
        if self._adaptive:
            return self._flush_adaptive(stream_ids)
        on_device = self._device_transform
        with _step("take"):
            taken = self._take(stream_ids)
        prepared = {}
        with _step("prepare"):
            for sid, arr in taken:
                prep = self._sessions[sid].prepare(arr,
                                                   transform=not on_device)
                if prep is not None:
                    prepared[sid] = prep
        if not prepared:
            return {}

        cdc = self._codec
        n_lem = cdc._lem_n()
        n_blocks = sum(p.nb for p in prepared.values())
        _M_ENC_FLUSH_BLOCKS.observe(n_blocks)
        nb_pad = self._nb_pad(prepared)
        _M_ENC_FLUSH_CELLS.inc(self._capacity * nb_pad)
        with _step("stage"):
            batch, valid = self._stage(prepared, nb_pad, raw=on_device)

        plan = self.plan
        # with a plan each shard copies its own slots to its device
        dev = cdc.torch_device if plan is None else None
        eb = cdc.error_bound
        if self._state is None:
            self._state = (
                init_state(cdc.num_dict, n_lem, channels=self._capacity,
                           device=dev, raw=eb is not None)
                if plan is None else
                init_sharded_state(cdc.num_dict, n_lem, plan.grid,
                                   channels=self._capacity,
                                   raw=eb is not None))
        kw = dict(num_dict=cdc.num_dict, d_crit=float(cdc.d_crit),
                  rel_tol=float(cdc.rel_tol), use_minmax=cdc.use_minmax,
                  use_ks=cdc.use_ks)
        if eb is not None:
            kw["error_bound"] = float(eb)
            kw["error_cumulative"] = cdc.mode == "delta"
        # the cuda backend's flush is one fused K1 launch by default; a
        # codec matcher overrides
        kw["matcher"] = cdc.matcher or (
            "fused" if cdc.backend == "cuda" else None)
        scan = (encode_decisions_batched if plan is None
                else functools.partial(_planned_scan, plan))
        with _step("h2d"):
            bt = torch.as_tensor(batch, device=dev)
            vt = torch.as_tensor(valid, device=dev)
        with _step("scan"):
            if on_device:
                # the whole batch's transform, bitwise the host's (see
                # core/transforms.py); the scan decides on its float32 cast
                fwd = delta_forward if cdc.mode == "delta" else \
                    residual_forward
                payload = fwd(bt, cdc.value_range)[1]
                bt = payload.to(torch.float32)
                payload = payload[:, :max(p.nb for p in prepared.values())]
                nan_rows = torch.isnan(payload).any(dim=-1)
                _M_TRANSFORM["device"].inc(n_blocks)
            (h, s, o), self._state = scan(bt, state=self._state, valid=vt,
                                          **kw)
        with _step("d2h"):
            h, s, o = (v.cpu().numpy() for v in (h, s, o))  # the one sync
            if on_device:
                payload = self._host_empty(payload.shape).copy_(
                    payload).numpy()
                nan_rows = nan_rows.cpu().numpy()

        with _step("commit"):
            out = {}
            for sid, prep in prepared.items():
                slot, nb = self._slots[sid], prep.nb
                if on_device:
                    self._redo_nan_blocks(payload[slot, :nb], prep.blocks[0],
                                          nan_rows[slot, :nb])
                    prep = prep._replace(
                        payloads=payload[slot:slot + 1, :nb],
                        bases=[prep.blocks[0][:, 0].copy()])
                dec = (h[slot, :nb], s[slot, :nb], o[slot, :nb])
                out[sid] = self._sessions[sid].commit(prep, [dec])[0]
        return out

    def _flush_adaptive(self, stream_ids: List[str]) -> Dict[str, bytes]:
        """Adaptive flush: each stream runs its per-stream feed cycle
        (selector switch at the flush boundary, observe, prepare) and the
        decide is ONE ``MixedCohort`` scan over the padded cohort -- slots
        carry per-stream mode, width and threshold as masked lanes.  Its
        steps are ``take``, ``prepare``, ``scan`` (the cohort's staging,
        copies, scan and sync) and ``commit``."""
        with _step("take"):
            taken = self._take(stream_ids)
        prepared = {}
        with _step("prepare"):
            for sid, arr in taken:
                sess = self._sessions[sid]
                # switches commit at the flush boundary (statistics through
                # the previous flushes), as IdealemSession._feed_adaptive
                # does
                ev = sess._selectors[0].decide(sess._stats[0].blocks)
                if ev is not None:
                    sess._apply_switch(0, ev)
                    if self._mixed is not None:
                        self._mixed.reset_lane(self._slots[sid])
                sess._selectors[0].observe(arr)
                prep = sess.prepare(arr)
                if prep is not None:
                    prepared[sid] = prep
        if not prepared:
            return {}

        _M_ENC_FLUSH_BLOCKS.observe(sum(p.nb for p in prepared.values()))
        nb_pad = self._nb_pad(prepared)
        _M_ENC_FLUSH_CELLS.inc(self._capacity * nb_pad)
        with _step("scan"):
            if self._mixed is None:
                cdc = self._codec
                self._mixed = MixedCohort(
                    cdc.num_dict, self._capacity, rel_tol=float(cdc.rel_tol),
                    use_minmax=cdc.use_minmax, use_ks=cdc.use_ks,
                    error_bound=cdc.error_bound,
                    matcher=_mixed_matcher_name(cdc),
                    device=cdc.torch_device, plan=self.plan)
            entries = []
            for sid, prep in prepared.items():
                sess = self._sessions[sid]
                cdc = sess._codecs[0]
                entries.append((self._slots[sid],
                                np.asarray(prep.payloads[0]),
                                float(sess._d_crit[0]), cdc.mode == "delta",
                                cdc.error_bound is not None))
            dec = self._mixed.decide(entries, nb_pad=nb_pad)
        with _step("commit"):
            return {sid: self._sessions[sid].commit(
                        prep, [dec[self._slots[sid]]])[0]
                    for sid, prep in prepared.items()}


class DecompressionService:
    """The read-side sibling of ``StreamCoalescer``: block-range reads out
    of packed containers (``repro_torch.store``).

    Containers are ``attach``\\ ed under an id; ``read`` answers one range
    at once, ``submit``/``flush`` coalesce many concurrent range requests
    -- ragged, across stores and channels -- into ONE padded reconstruct
    per compatible group.  On a device backend all compatible requests of
    a flush, even across containers, merge into one dispatch (per-store
    parse and gather stay on the host).  The ``FlushPolicy`` decides when
    to stop accumulating: ``max_batch_blocks`` bounds the pending blocks,
    ``max_batch_streams`` the waiting requests, ``max_age_s`` the
    deadline (on an injectable clock).

    Parsed chunks are kept in a per-service LRU keyed by ``(container
    identity, chunk)`` -- ``Container.cache_token`` -- so two attaches of
    one archive share walks; eviction is by total cached blocks.

    Flushes are pipelined: plan -> gather -> reconstruct -> emit, the
    reconstruct stage handed to a stage executor (``serve.pipeline``).
    With ``FlushPolicy.pipeline_depth == 1`` a flush returns its own
    batch's answers; with depth 2 a worker thread reconstructs batch N
    while the caller plans and gathers batch N+1, a flush returns the
    answers of the batch that just completed, and ``drain()`` (or
    ``close()``) collects the rest.  A store that fails in any stage fails
    alone: its requests go to ``last_errors``, as do a group's requests
    when ``"auto"`` finds no exact backend for it.  ``executor`` (any object
    with ``submit(fn, *args) -> future`` and ``shutdown()``) is injectable
    for tests.  Each stage is a ``serve.<stage>`` span (attrs ``seq``,
    the flush's number) with its ``repro_serve_stage_seconds`` child.

    ``backend`` defaults to ``"cuda"`` (the reference package's default is
    ``"auto"``); ``"auto"`` routes every dispatch to the measured-best
    backend for its (mode, dtype, size bucket)
    (``repro_torch.core.decode.resolve_backend``).  The tensor backends
    run on ``device`` (default ``"cuda"``, raising without a GPU).
    """

    def __init__(self, policy: Optional[FlushPolicy] = None,
                 cache_blocks: int = 1 << 16,
                 clock: Optional[Callable[[], float]] = None,
                 backend: str = "cuda",
                 executor=None,
                 device=None):
        if backend != "auto" and backend not in decode_mod.BACKENDS:
            raise ValueError(f"unknown decode backend {backend!r}")
        self.policy = policy or FlushPolicy()
        self.backend = backend
        self.device = None if backend == "numpy" else resolve_device(device)
        self._cache_blocks = cache_blocks
        self._clock = clock if clock is not None else time.monotonic
        self._stores: Dict[str, object] = {}
        self._seeds: Dict[str, int] = {}
        self._cache: "OrderedDict[Tuple[tuple, int], object]" = OrderedDict()
        self._cached_blocks = 0
        # pending request: (id, store, channel, start, stop, submit ts);
        # FIFO order makes the head the batch's oldest for the deadline
        self._pending: List[Tuple[str, str, int, int, int, float]] = []
        self._pending_blocks = 0
        if executor is None:
            executor = (ThreadStageExecutor() if self.policy.pipeline_depth > 1
                        else SyncExecutor())
        self._pipe = StagePipeline(executor, self.policy.pipeline_depth)
        self._flush_seq = 0
        self._closed = False
        # answers emitted outside a collection point (a quiesce before a
        # cold autotune probe), delivered with the next flush/drain/poll
        self._early_out: Dict[str, np.ndarray] = {}
        self.stats = {"requests": 0, "blocks_out": 0, "flushes": 0,
                      "failed_requests": 0, "cache_hits": 0,
                      "cache_misses": 0, "dispatches": 0, "inflight_peak": 0}
        self.last_errors: Dict[str, Exception] = {}

    # ------------------------------------------------------------- lifecycle
    def attach(self, store_id: str, container, seed: int = 0) -> None:
        """Register a container (bytes or ``repro_torch.store.Container``)
        for serving.  ``seed`` pins the decoder's hit-permutation stream."""
        if store_id in self._stores:
            raise KeyError(f"store {store_id!r} already attached")
        if not isinstance(container, Container):
            container = Container(container)
        self._stores[store_id] = container
        self._seeds[store_id] = seed

    def detach(self, store_id: str) -> None:
        token = self._store(store_id).cache_token
        del self._stores[store_id]
        del self._seeds[store_id]
        # evict the departing container's parsed chunks, unless another
        # attached store shares its cache token
        live = {c.cache_token for c in self._stores.values()}
        if token not in live:
            self._cache = OrderedDict(
                (k, v) for k, v in self._cache.items() if k[0] != token)
            self._cached_blocks = sum(len(p.is_hit)
                                      for p in self._cache.values())
        # staged requests against the departing store cannot be answered:
        # they go to last_errors, as a failed flush group's do
        dropped = [r for r in self._pending if r[1] == store_id]
        for rid, *_ in dropped:
            self.last_errors[rid] = KeyError(
                f"store {store_id!r} detached with request pending")
        self._acct("failed_requests", len(dropped))
        self._pending = [r for r in self._pending if r[1] != store_id]
        self._pending_blocks = sum(r[4] - r[3] for r in self._pending)

    @property
    def attached_stores(self) -> List[str]:
        return sorted(self._stores)

    # ------------------------------------------------------------ read paths
    def read(self, store_id: str, start_block: int, stop_block: int,
             channel: int = 0) -> np.ndarray:
        """Synchronous single-range read through the chunk cache."""
        store = self._store(store_id)
        out = decode_range(store, start_block, stop_block, channel=channel,
                           seed=self._seeds[store_id],
                           parse=self._parse_for(store_id),
                           backend=self.backend, device=self.device)
        self._acct("requests")
        self._acct("blocks_out", stop_block - start_block)
        return out

    def handle(self, req):
        """Serve one wire-typed :class:`repro_torch.api.DecodeRangeRequest`
        synchronously (the :meth:`read` path) and return its
        :class:`repro_torch.api.RangeResult`."""
        values = self.read(req.store_id, req.start_block, req.stop_block,
                           channel=req.channel)
        return api.RangeResult(request_id=req.request_id, values=values)

    def read_channels(self, store_id: str,
                      channels: Optional[Sequence[int]] = None
                      ) -> Dict[int, np.ndarray]:
        """Full decode of whole channels (tails included), batched."""
        store = self._store(store_id)
        out = decode_channels(store, channels,
                              seed=self._seeds[store_id],
                              parse=self._parse_for(store_id),
                              backend=self.backend, device=self.device)
        self._acct("requests", len(out))
        self._acct("blocks_out",
                   sum(store.total_blocks(c) for c in out))
        return out

    def submit(self, request_id: str, store_id: str, start_block: int,
               stop_block: int, channel: int = 0
               ) -> Optional[Dict[str, np.ndarray]]:
        """Stage a range request; when the flush policy trips, returns the
        flush's answers by request id -- at ``pipeline_depth`` 1 this very
        batch, at depth > 1 whatever batches just completed.  Returns
        ``None`` while the policy holds."""
        self._check_open()
        store = self._store(store_id)
        total = store.total_blocks(channel)
        if not (0 <= start_block < stop_block <= total):
            raise IndexError(
                f"block range [{start_block}, {stop_block}) outside "
                f"[0, {total}) of {store_id!r} channel {channel}")
        if request_id in self._live_request_ids():
            raise KeyError(f"request {request_id!r} already pending")
        self._pending.append(
            (request_id, store_id, channel, start_block, stop_block,
             self._clock()))
        self._pending_blocks += stop_block - start_block
        if self.policy.should_flush(len(self._pending), self._pending_blocks,
                                    self._age()):
            return self.flush()
        return None

    def poll(self) -> Optional[Dict[str, np.ndarray]]:
        """Deadline tick (``FlushPolicy.max_age_s``); also delivers, without
        blocking, any pipelined batch that finished since the last call."""
        if self._pending and self.policy.should_flush(
                len(self._pending), self._pending_blocks, self._age()):
            return self.flush()
        ready = {**self._take_early(), **self._collect_ready()}
        return ready or None

    def flush(self) -> Dict[str, np.ndarray]:
        """Cut the pending batch through the staged pipeline and return the
        answers of every batch that completed.

        *plan*: per store, seek and walk the covering chunks
        (``store.plan_windows``); a failing store's requests go to
        ``last_errors`` and every other store proceeds.  *gather*: one
        byte gather per store (``store.gather_parts``), parts sharing codec
        parameters and seed merged across stores and padded into one plan
        per group (``decode.pad_parts``).  A host-routed group splits by
        pow-2 request length; a device group merges, unless its padded size
        exceeds both the policy's block budget and 4x its real work, when
        it re-splits by length bucket.  *reconstruct*: one
        ``decode.reconstruct`` per group (``stats["dispatches"]``), inline
        at depth 1, on the worker thread at depth 2.  *emit*: slice each
        request's blocks out, account stats, quarantine failures.

        ``last_errors`` accumulates; callers ``pop`` entries they have
        handled."""
        self._check_open()
        age = self._age()
        if age is not None:
            _M_FLUSH_AGE.observe(age)
        pending, self._pending = self._pending, []
        self._pending_blocks = 0
        out: Dict[str, np.ndarray] = self._take_early()
        if not pending:
            # nothing to cut, but completed batches must not be stranded
            out.update(self._collect_ready())
            return out
        self._flush_seq += 1
        seq = self._flush_seq
        units = self._stage_gather(seq, self._stage_plan(seq, pending))
        completed = self._pipe.push((seq, units),
                                    self._stage_reconstruct, seq, units)
        self._acct("flushes")
        self.stats["inflight_peak"] = max(
            self.stats["inflight_peak"], self._pipe.inflight + len(completed))
        _M_INFLIGHT.set(self._pipe.inflight)
        for (seq_done, batch_units), outcomes, exc in completed:
            out.update(self._stage_emit(seq_done, batch_units, outcomes, exc))
        out.update(self._take_early())  # batches drained by a probe quiesce
        return out

    def drain(self) -> Dict[str, np.ndarray]:
        """Collect every in-flight batch's answers (blocking); a no-op at
        depth 1."""
        out: Dict[str, np.ndarray] = self._take_early()
        for (seq_done, batch_units), outcomes, exc in self._pipe.drain():
            out.update(self._stage_emit(seq_done, batch_units, outcomes, exc))
        _M_INFLIGHT.set(self._pipe.inflight)
        return out

    def close(self) -> Dict[str, np.ndarray]:
        """Flush the pending batch, drain the pipeline and shut the stage
        executor down; returns every answer not yet handed out.  Later
        ``submit``/``flush`` raise; a repeated ``close()`` is a no-op."""
        if self._closed:
            return {}
        out = self.flush()
        out.update(self.drain())
        self._pipe.executor.shutdown()
        self._closed = True
        return out

    @property
    def inflight(self) -> int:
        """Reconstruct batches in flight (at most ``pipeline_depth - 1``
        between calls)."""
        return self._pipe.inflight

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("DecompressionService is closed")

    def _acct(self, key: str, n: int = 1) -> None:
        """Bump a service stat and its ``repro_serve_*_total`` mirror."""
        self.stats[key] += n
        _M_SERVE[key].inc(n)

    def _collect_ready(self) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for (seq_done, batch_units), outcomes, exc in \
                self._pipe.collect_ready():
            out.update(self._stage_emit(seq_done, batch_units, outcomes, exc))
        return out

    def _take_early(self) -> Dict[str, np.ndarray]:
        out, self._early_out = self._early_out, {}
        return out

    def _live_request_ids(self) -> set:
        """Ids not yet reusable: staged requests and every request of an
        in-flight batch."""
        ids = {r[0] for r in self._pending}
        for _seq, units in self._pipe.metas():
            for u in units:
                ids.update(rid for rid, _ in u.items)
        return ids

    # --------------------------------------------------------- flush stages
    def _stage_plan(self, seq: int, pending) -> List[_PlannedStore]:
        with _staged("plan", seq, requests=len(pending)):
            return self._plan_impl(seq, pending)

    def _plan_impl(self, seq: int, pending) -> List[_PlannedStore]:
        by_store: Dict[tuple, List[Tuple[str, int, int, int]]] = {}
        headers: Dict[Tuple[str, int], object] = {}  # per-flush header memo
        for rid, sid, channel, start, stop, _ts in pending:
            try:
                hdr = headers.get((sid, channel))
                if hdr is None:
                    store = self._stores[sid]
                    hdr = headers[(sid, channel)] = store.header_of(
                        int(store.chunks_of(channel)[0]))
            except Exception as e:  # corrupt header / racing detach
                self.last_errors[rid] = e
                self._acct("failed_requests")
                continue
            pkey = (hdr.mode, hdr.block_size, np.dtype(hdr.dtype).str,
                    hdr.value_range, bool(hdr.error_bounded))
            by_store.setdefault((sid,) + pkey, []).append(
                (rid, channel, start, stop))

        planned = []
        for (sid, *pkey), reqs in by_store.items():
            ranges = [(c, i, j) for _, c, i, j in reqs]
            try:
                hdr, windows = plan_windows(self._stores[sid], ranges,
                                            parse=self._parse_for(sid))
            except Exception as e:  # quarantine this store's requests
                for rid, _, _, _ in reqs:
                    self.last_errors[rid] = e
                self._acct("failed_requests", len(reqs))
                continue
            planned.append(_PlannedStore(sid, tuple(pkey), reqs, ranges,
                                         hdr, windows))
        return planned

    def _stage_gather(self, seq: int,
                      planned: List[_PlannedStore]) -> List[_Unit]:
        with _staged("gather", seq, stores=len(planned)):
            return self._gather_impl(seq, planned)

    def _gather_impl(self, seq: int,
                     planned: List[_PlannedStore]) -> List[_Unit]:
        pregroups: Dict[tuple, List[Tuple[str, int, object]]] = {}
        for ps in planned:
            try:
                parts = gather_parts(self._stores[ps.store_id], ps.header,
                                     ps.windows, ps.ranges)
            except Exception as e:  # quarantine this store's requests
                for rid, _, _, _ in ps.requests:
                    self.last_errors[rid] = e
                self._acct("failed_requests", len(ps.requests))
                continue
            pre = (ps.pkey, self._seeds[ps.store_id])
            for (rid, _, i, j), part in zip(ps.requests, parts):
                pregroups.setdefault(pre, []).append((rid, j - i, part))

        # resolve each MERGED group's backend at its true dispatch size
        groups: Dict[tuple, List[Tuple[str, int, object]]] = {}
        for (pkey, seed), items in pregroups.items():
            mode, B, dt_str, vr, _eb = pkey
            total = sum(n for _, n, _ in items)
            if (self.backend == "auto" and self._pipe.inflight
                    and not decode_mod.autotune_cached(mode, dt_str, total,
                                                       self.device)):
                # cold combination: quiesce the pipeline before the timing
                # probe (an in-flight reconstruct would poison the choice);
                # the drained answers ride out with this flush
                for (sq, bu), oc, ex in self._pipe.drain():
                    self._early_out.update(
                        self._stage_emit(sq, bu, oc, ex))
            try:
                eff = decode_mod.resolve_backend(self.backend, mode, dt_str,
                                                 total, vr, B, self.device)
            except Exception as e:  # "auto" found no exact backend
                for rid, _, _ in items:
                    self.last_errors[rid] = e
                self._acct("failed_requests", len(items))
                continue
            if eff == "numpy":
                # host path: split by pow-2 length bucket (padding control)
                for it in items:
                    groups.setdefault(
                        (pkey, seed, decode_mod._pow2(it[1]), eff),
                        []).append(it)
            else:
                groups[(pkey, seed, 0, eff)] = items

        # a merged device group must not let one huge request pad many
        # tiny ones: beyond both the policy block budget and 4x the real
        # work, re-split by pow-2 length bucket
        split: List[Tuple[tuple, List[Tuple[str, int, object]]]] = []
        for gkey, items in groups.items():
            lens = [n for _, n, _ in items]
            padded = len(items) * max(lens)
            if (len(items) > 1 and padded > sum(lens) * 4
                    and padded > self.policy.max_batch_blocks):
                subs: Dict[int, List[Tuple[str, int, object]]] = {}
                for it in items:
                    subs.setdefault(decode_mod._pow2(it[1]), []).append(it)
                split.extend((gkey, sub) for sub in subs.values())
            else:
                split.append((gkey, items))

        units: List[_Unit] = []
        for ((mode, B, dt_str, vr, eb), seed, _bucket, eff), items in split:
            try:
                plan, nbm = decode_mod.pad_parts(
                    mode, B, np.dtype(dt_str), vr,
                    [part for _, _, part in items], seed=seed, no_perm=eb)
            except Exception as e:
                for rid, _, _ in items:
                    self.last_errors[rid] = e
                self._acct("failed_requests", len(items))
                continue
            units.append(_Unit(eff, B, [(rid, n) for rid, n, _ in items],
                               plan, nbm))
        return units

    def _stage_reconstruct(self, seq: int, units: List[_Unit]) -> list:
        """Device stage: one engine dispatch per unit.  May run on the
        executor's worker thread, so it touches no shared service state:
        failures are captured per unit and accounted at emit."""
        with _staged("reconstruct", seq, units=len(units)):
            return self._reconstruct_impl(seq, units)

    def _reconstruct_impl(self, seq: int, units: List[_Unit]) -> list:
        outcomes = []
        for u in units:
            try:
                body = decode_mod.reconstruct(u.plan, backend=u.backend,
                                              device=self.device)
            except Exception as e:
                outcomes.append((u, None, e))
            else:
                outcomes.append((u, body, None))
        return outcomes

    def _stage_emit(self, seq: int, units: List[_Unit], outcomes,
                    exc: Optional[BaseException]) -> Dict[str, np.ndarray]:
        with _staged("emit", seq, units=len(units)):
            return self._emit_impl(seq, units, outcomes, exc)

    def _emit_impl(self, seq: int, units: List[_Unit], outcomes,
                   exc: Optional[BaseException]) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        if exc is not None:  # the whole reconstruct stage died
            outcomes = [(u, None, exc) for u in units]
        for u, body, u_exc in outcomes or []:
            if u_exc is not None:
                for rid, _ in u.items:
                    self.last_errors[rid] = u_exc
                self._acct("failed_requests", len(u.items))
                continue
            body = body.reshape(len(u.items), u.nbm, u.block_size)
            self._acct("dispatches")
            for r, (rid, n) in enumerate(u.items):
                out[rid] = body[r, :n].ravel()
                self._acct("blocks_out", n)
            self._acct("requests", len(u.items))
        return out

    # ------------------------------------------------------------- internals
    def _store(self, store_id: str):
        try:
            return self._stores[store_id]
        except KeyError:
            raise KeyError(f"store {store_id!r} is not attached") from None

    def _parse_for(self, store_id: str):
        """LRU-caching wrapper around ``repro_torch.store.parse_chunk``,
        keyed on the container's ``cache_token`` so a re-attach, or a
        second ``Container`` over the same file, reuses cached walks."""
        token = self._store(store_id).cache_token

        def parse(store, chunk):
            key = (token, chunk)
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.move_to_end(key)
                self._acct("cache_hits")
                return hit
            self._acct("cache_misses")
            parsed = parse_chunk(store, chunk)
            self._cache[key] = parsed
            self._cached_blocks += len(parsed.is_hit)
            while self._cache and self._cached_blocks > self._cache_blocks:
                _, old = self._cache.popitem(last=False)
                self._cached_blocks -= len(old.is_hit)
            return parsed

        return parse

    def _age(self) -> Optional[float]:
        if not self._pending:
            return None
        return self._clock() - self._pending[0][5]
