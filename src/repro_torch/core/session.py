"""Streaming codec sessions.

``IdealemCodec.encode`` is one-shot: the dictionary is built from scratch
per call.  For the paper's deployment -- online compression of continuous
sensor/PMU streams (Sec. I, Fig. 15) -- that would destroy the hit rate the
FIFO dictionary exists to provide whenever data arrives in chunks.

``IdealemSession`` owns the persistent encoder state between chunks:

  * the per-channel ``DictState`` on the codec's device (or the numpy
    ``NpDictState`` list for the ``"numpy"`` backend), threaded through the
    resumable scan so chunked encoding makes exactly the same decisions as
    one pass;
  * per-channel host tail buffers for samples that do not yet fill a block;
  * segment emission: ``feed(chunk) -> bytes`` returns an append-mode stream
    segment (FLAG_MORE/FLAG_CONT framing, see ``core.stream``) and
    ``finish() -> bytes`` the final segment carrying the tail.  The
    concatenated segments decode identically to a one-shot encode of the
    concatenated samples.

With ``emit_segments=False`` the session buffers host-side and ``finish``
assembles one classic single-segment stream; ``IdealemCodec.encode`` is a
thin wrapper over this mode.  ``channels=C`` encodes C independent streams
in one batched scan; ``feed`` then takes ``(C, m)`` chunks and returns one
segment per channel.

Adaptive codecs (``IdealemCodec(adaptive=True)``) carry one
:class:`~repro_torch.core.select.ChannelSelector` per channel: at a feed
boundary a channel may switch its transform (std/residual/delta) and its
d_crit scale, which resets its dictionary and restarts its segment chain.
The channels' payloads then differ in width, threshold and error metric;
a :class:`MixedCohort` pads them into one batch and decides a feed in one
mixed-mode scan (on ``backend="cuda"`` one launch of K1 with its ``chan``
operand).  Matchers without a masked variant (``"ops"``, ``"auto"``) take
a per-channel loop, as does every session while the environment variable
``REPRO_TORCH_ADAPTIVE_LOOP`` is set (the oracle arm for tests).

``plan=`` (``repro_torch.launch.encode_plan.EncodePlan``) spreads the
scan over the plan's devices: the channels padded to the plan's padded
count (pad lanes masked), each shard's carry resident on its device
between feeds, the dictionary rows split too when ``dict_shards > 1``
(static sessions only).  The bytes are those of the session without a
plan.

``container=True`` also appends every emitted segment to an in-memory
indexed container (``repro_torch.store``); ``finish()`` then returns that
container.  Sessions count into the port's registry (``repro_torch.obs``)
under the reference's names, once per feed, dispatch or segment.
"""
from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, List, NamedTuple, Optional, Union

import numpy as np
import torch

from .. import obs
from ..device import resolve_device
from . import stream as stream_mod
from .stream import StreamHeader

if TYPE_CHECKING:  # pragma: no cover
    from .idealem import IdealemCodec

__all__ = ["IdealemSession", "MixedCohort", "PreparedChunk", "SessionStats"]

# Process-wide aggregates over every session and channel; per-channel
# detail stays on ``SessionStats``.
_M = {
    key: obs.registry().counter(f"repro_encode_{key}_total", help_text)
    for key, help_text in {
        "bytes_in": "raw sample bytes accepted by sessions",
        "bytes_out": "emitted segment bytes (compressed size)",
        "segments": "stream segments emitted",
        "blocks": "blocks encoded",
        "hits": "blocks replaced by a dictionary reference",
        "mode_switches": "adaptive selector mode/scale switches applied",
    }.items()
}
# Blocks given the residual or delta transform, by where it ran: on the
# host in ``IdealemSession.prepare``, or on the device in a coalescer's
# flush (``serve/compress.py``).  std blocks count nothing.
_M_TRANSFORM = {
    where: obs.registry().counter(
        "repro_encode_transform_blocks_total",
        "blocks given the residual or delta transform, by where it ran",
        labels={"where": where})
    for where in ("device", "host")
}
# Adaptive sessions: one dispatch a feed on the batched arm, one per
# channel on the loop arm; the cohort histogram records the channels each
# feed's dispatches covered.
_M_DISPATCH = {
    path: obs.registry().counter(
        "repro_encode_dispatches_total",
        "device encode-scan dispatches by path",
        labels={"path": path})
    for path in ("adaptive_batched", "adaptive_loop")
}
_M_COHORT = obs.registry().histogram(
    "repro_encode_adaptive_cohort",
    "channels covered per adaptive encode dispatch (cohort size)",
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0,
             1024.0))

# Forces the per-channel loop in adaptive sessions (the port's own variable:
# the reference package's REPRO_ADAPTIVE_LOOP is not read).
_ADAPTIVE_LOOP_ENV = "REPRO_TORCH_ADAPTIVE_LOOP"


def _planned_scan(plan, blocks_cn, **kw):
    """One resumable scan through an encode plan (``state`` the
    ``ShardedState`` on the plan's grid): the dictionary-sharded scan when
    the plan splits the rows, else the channel-sharded one."""
    from .encoder import encode_decisions_dsharded, encode_decisions_sharded
    if plan.dict_shards > 1:
        return encode_decisions_dsharded(blocks_cn, grid=plan.grid, **kw)
    return encode_decisions_sharded(blocks_cn, devices=plan.devices, **kw)


def _mixed_matcher_name(codec) -> Optional[str]:
    """The mixed scan's matcher for a codec: ``"fused"`` (the ``"cuda"``
    backend's default) or ``"reference"`` (``"torch"``'s), or ``None``
    when only the per-channel loop can honour it (``"ops"``/``"auto"``
    have no masked variant)."""
    m = codec.matcher
    if codec.backend == "cuda":
        m = m or "fused"
    if m is None or m == "reference":
        return "reference"
    return "fused" if m == "fused" else None


class MixedCohort:
    """Shared batched carry and dispatcher of an adaptive session's
    channels.

    Owns one ``(capacity, D, n_max)`` ``DictState`` whose lanes stay
    logically per channel: payload widths are padded to the widest live
    lane with ``+inf`` (:func:`~repro_torch.core.encoder.repad_state_n`
    follows the widest as lanes change), tail columns are masked per lane
    inside the scan, and a selector switch resets a lane in place
    (:meth:`reset_lane`).  :meth:`decide` stages the padded batch on the
    host and issues one mixed-mode scan and one host sync per feed however
    the lanes differ in mode, width, threshold or error metric;
    ``dispatches`` counts them and ``stage_s`` sums the host seconds spent
    staging the batches (padding them and copying them to the device).

    With an encode ``plan`` the lanes are the plan's padded channels, split
    over its devices (one scan a shard, each shard's carry on its device),
    and the cohort cannot grow.
    """

    def __init__(self, num_dict: int, capacity: int, *, rel_tol: float,
                 use_minmax: bool = True, use_ks: bool = True,
                 error_bound: Optional[float] = None,
                 matcher: Optional[str] = None, device=None, plan=None):
        if plan is not None and capacity != plan.padded_channels:
            raise ValueError(
                f"cohort capacity {capacity} != plan padded_channels "
                f"{plan.padded_channels}")
        self.plan = plan
        self.num_dict = int(num_dict)
        self.capacity = int(capacity)
        self.rel_tol = float(rel_tol)
        self.use_minmax = use_minmax
        self.use_ks = use_ks
        self.error_bound = None if error_bound is None else float(error_bound)
        self.matcher = matcher
        self.device = resolve_device(device)
        # batched DictState (a ShardedState with a plan), width padded to
        # _n_max
        self.state = None
        self._n_max = 0
        self.lane_n = np.zeros(self.capacity, dtype=np.int64)
        self.dispatches = 0
        self.stage_s = 0.0

    def reset_lane(self, lane: int) -> None:
        """Drop one lane's dictionary (selector switch): its rows turn
        ``valid=False`` and its FIFO count rewinds; every other lane's
        carry is untouched.  Updates the cohort's own carry in place."""
        from .encoder import reset_channel
        self.lane_n[lane] = 0
        if self.state is not None:
            reset_channel(self.state, lane)

    def grow(self, capacity: int) -> None:
        """Extend the lane axis; new lanes start empty."""
        add = int(capacity) - self.capacity
        if add <= 0:
            return
        if self.plan is not None:
            raise ValueError("plan-pinned cohorts cannot grow")
        self.lane_n = np.concatenate(
            [self.lane_n, np.zeros(add, dtype=np.int64)])
        if self.state is not None:
            self.state = type(self.state)(*(
                torch.cat([f, f.new_zeros((add,) + f.shape[1:])])
                for f in self.state))
        self.capacity = int(capacity)

    def decide(self, entries, *, nb_pad: Optional[int] = None):
        """One mixed-mode scan over ``entries``: a list of ``(lane, payload
        (nb_i, n_i), d_crit, err_cum, eb_on)`` tuples.  Payload widths are
        padded to the cohort's widest with +inf (as float32, on the host)
        and block counts to ``max(nb_pad, the most of any entry)`` through
        the valid mask (a coalescer passes its bucketed length).  Returns
        ``{lane: (is_hit, slot, overwrite)}`` cut back to each entry's block
        count, after the one host sync."""
        from .encoder import (encode_decisions_mixed,
                              encode_decisions_mixed_sharded,
                              init_sharded_state, init_state, repad_state_n)

        t0 = time.perf_counter()
        for lane, p, *_ in entries:
            self.lane_n[lane] = p.shape[-1]
        n_max = int(self.lane_n.max())
        nb = max(p.shape[0] for _, p, *_ in entries)
        if nb_pad is not None:
            nb = max(nb, int(nb_pad))
        batch = np.full((self.capacity, nb, n_max), np.inf, dtype=np.float32)
        valid = np.zeros((self.capacity, nb), dtype=bool)
        d_crit = np.ones(self.capacity, dtype=np.float32)
        err_cum = np.zeros(self.capacity, dtype=bool)
        eb_on = np.zeros(self.capacity, dtype=bool)
        for lane, p, dc, ec, ebo in entries:
            nb_i, n_i = p.shape
            batch[lane, :nb_i, :n_i] = p
            valid[lane, :nb_i] = True
            d_crit[lane] = dc
            err_cum[lane] = ec
            eb_on[lane] = ebo
        eb = self.error_bound
        plan = self.plan
        if self.state is None:
            self.state = (
                init_state(self.num_dict, n_max, channels=self.capacity,
                           device=self.device, raw=eb is not None)
                if plan is None else
                init_sharded_state(self.num_dict, n_max, plan.grid,
                                   channels=self.capacity, raw=eb is not None))
        elif n_max != self._n_max:
            self.state = (repad_state_n(self.state, n_max) if plan is None
                          else self.state.map(
                              lambda st: repad_state_n(st, n_max)))
        self._n_max = n_max
        # with a plan each shard copies its own lanes to its device
        dev = self.device if plan is None else None
        batch = torch.as_tensor(batch, device=dev)
        valid = torch.as_tensor(valid, device=dev)
        self.stage_s += time.perf_counter() - t0
        kw = dict(num_dict=self.num_dict, n_valid=np.maximum(self.lane_n, 1),
                  d_crit=d_crit, rel_tol=self.rel_tol,
                  use_minmax=self.use_minmax, use_ks=self.use_ks,
                  error_bound=eb, error_cumulative=err_cum, eb_on=eb_on,
                  matcher=self.matcher, state=self.state, valid=valid)
        if plan is None:
            (h, s, o), self.state = encode_decisions_mixed(batch, **kw)
        else:
            (h, s, o), self.state = encode_decisions_mixed_sharded(
                batch, devices=plan.devices, **kw)
        self.dispatches += 1
        _M_DISPATCH["adaptive_batched"].inc()
        _M_COHORT.observe(float(len(entries)))
        h, s, o = (v.cpu().numpy() for v in (h, s, o))  # the one sync
        return {lane: (h[lane, :p.shape[0]], s[lane, :p.shape[0]],
                       o[lane, :p.shape[0]])
                for lane, p, *_ in entries}


class PreparedChunk(NamedTuple):
    """Host-side staging of one feed: complete blocks cut from the chunk
    (tails already re-buffered) with their transforms applied (or, from
    ``prepare(transform=False)``, left to the caller: ``payloads`` is then
    ``None`` and ``bases`` all ``None`` until the caller fills them)."""

    blocks: np.ndarray            # (C, nb, B) raw values
    payloads: np.ndarray          # (C, nb, n_lem) transformed; adaptive
                                  # sessions: a list of (nb, n_c) arrays
    bases: List[Optional[np.ndarray]]  # per channel, (nb,) or None (std)
    nb: int


@dataclass
class SessionStats:
    """Per-channel accounting of a streaming session."""

    blocks: int = 0
    hits: int = 0
    segments: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    # adaptive sessions: accepted selector switches and their events
    mode_switches: int = 0
    events: List[dict] = field(default_factory=list)

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.blocks, 1)

    def as_dict(self) -> dict:
        return {
            "blocks": self.blocks, "hits": self.hits,
            "hit_rate": self.hit_rate, "segments": self.segments,
            "bytes_in": self.bytes_in, "bytes_out": self.bytes_out,
            "ratio": self.bytes_in / max(self.bytes_out, 1),
            "mode_switches": self.mode_switches,
            "events": list(self.events),
        }


class IdealemSession:
    """Resumable encode session over one codec configuration.

    >>> codec = IdealemCodec(mode="std", block_size=32, num_dict=255)
    >>> s = codec.session()
    >>> parts = [s.feed(chunk) for chunk in chunks] + [s.finish()]
    >>> y = codec.decode(b"".join(parts))   # == decode of one-shot encode
    """

    def __init__(self, codec: "IdealemCodec", channels: Optional[int] = None,
                 emit_segments: bool = True, dtype=np.float64, plan=None,
                 container: bool = False):
        if channels is not None and channels < 1:
            raise ValueError("channels must be >= 1")
        C = channels if channels is not None else 1
        if plan is not None:
            if codec.backend == "numpy":
                raise ValueError("encode plans need a device backend")
            if plan.channels != C:
                raise ValueError(
                    f"plan is for {plan.channels} channels, session has {C}")
        self.plan = plan  # launch.encode_plan.EncodePlan
        self.codec = codec
        self.channels = channels
        self.emit_segments = emit_segments
        self._writer = None
        if container:
            if codec.adaptive:
                raise ValueError(
                    "adaptive sessions do not support container output")
            from ..store.container import ContainerWriter
            self._writer = ContainerWriter()
        self.dtype = np.dtype(dtype)
        C = self._C = channels if channels is not None else 1
        self._tails = [np.zeros(0, dtype=self.dtype) for _ in range(C)]
        self._started = [False] * C  # any segment emitted yet (per channel)
        self._finished = False
        self._stats = [SessionStats() for _ in range(C)]
        # batched DictState (torch / cuda backends; a ShardedState with a
        # plan)
        self._dev_state = None
        self._np_states = None   # list[NpDictState] (numpy backend)
        # adaptive sessions: each channel's current codec variant and
        # quantized d_crit; a switch resets the channel's dictionary and
        # restarts its segment chain
        self.adaptive = bool(codec.adaptive)
        self._codecs = [codec] * C
        self._d_crit = [float(codec.d_crit)] * C
        self._selectors = None
        self._adapt_states = None  # per-channel DictState (the loop arm)
        self._mixed = None            # MixedCohort (the batched arm)
        self._mixed_disabled = False  # the matcher has no masked variant
        if self.adaptive:
            if not emit_segments:
                raise ValueError(
                    "adaptive sessions require emit_segments=True (mode "
                    "switches live at segment restarts)")
            if plan is not None:
                # the batched mixed scan shards the channel axis only
                plan.validate_adaptive()
                if _mixed_matcher_name(codec) is None:
                    raise ValueError(
                        "adaptive sessions with an encode plan need the "
                        "reference or fused matcher (the batched mixed scan "
                        f"has no masked variant of {codec.matcher!r})")
            from .select import ChannelSelector
            self._selectors = [
                ChannelSelector(codec.block_size, mode=codec.mode,
                                config=codec.selector) for _ in range(C)]
            self._adapt_states = [None] * C
        # host-side accumulation for emit_segments=False (one-shot assembly)
        self._buf = [
            {"raw": [], "payload": [], "bases": [], "hit": [], "slot": [],
             "ovw": []}
            for _ in range(C)
        ]

    # ------------------------------------------------------------- internals
    def _decide(self, payload_cn: np.ndarray):
        """(C, nb, n_lem) transformed blocks -> per-channel decision triples,
        threading the persistent dictionary carry."""
        cdc = self.codec
        kw = dict(num_dict=cdc.num_dict, d_crit=float(cdc.d_crit),
                  rel_tol=float(cdc.rel_tol), use_minmax=cdc.use_minmax,
                  use_ks=cdc.use_ks)
        eb = cdc.error_bound
        if eb is not None:
            kw["error_bound"] = float(eb)
            kw["error_cumulative"] = cdc.mode == "delta"
        if cdc.backend == "numpy":
            from .npref import encode_decisions_np, np_init_state
            if self._np_states is None:
                self._np_states = [np_init_state(cdc.num_dict)
                                   for _ in range(self._C)]
            return [
                encode_decisions_np(payload_cn[ci],
                                    state=self._np_states[ci], **kw)[0]
                for ci in range(self._C)
            ]
        from .encoder import encode_decisions_batched, init_state
        # the "cuda" backend defaults to the fused kernel scan; an explicit
        # codec matcher ("ops", "auto", ...) overrides
        kw["matcher"] = cdc.matcher or (
            "fused" if cdc.backend == "cuda" else None)
        if self.plan is not None:
            return self._decide_planned(payload_cn, kw)
        # payloads reach the scan as f32 whatever the stream dtype
        pt = torch.as_tensor(payload_cn, dtype=torch.float32,
                             device=cdc.torch_device)
        if self._dev_state is None:
            self._dev_state = init_state(cdc.num_dict, pt.shape[-1],
                                         channels=self._C, device=pt.device,
                                         raw=eb is not None)
        (h, s, o), self._dev_state = encode_decisions_batched(
            pt, state=self._dev_state, **kw)
        h, s, o = (v.cpu().numpy() for v in (h, s, o))
        return [(h[ci], s[ci], o[ci]) for ci in range(self._C)]

    def _decide_planned(self, payload_cn: np.ndarray, kw: dict):
        """:meth:`_decide` through the encode plan: channels padded to the
        plan's count (pad lanes masked, their decisions dropped), each
        shard's slice copied to its device, one scan a shard (the
        dictionary-sharded scan when the plan splits rows)."""
        from .encoder import init_sharded_state
        plan = self.plan
        pad = plan.padded_channels - self._C
        # payloads reach the scan as f32 whatever the stream dtype
        pt = torch.as_tensor(payload_cn, dtype=torch.float32)
        if pad:
            pt = torch.cat([pt, pt.new_zeros((pad,) + pt.shape[1:])])
        valid = torch.ones(pt.shape[:2], dtype=torch.bool)
        valid[self._C:] = False
        if self._dev_state is None:
            self._dev_state = init_sharded_state(
                kw["num_dict"], pt.shape[-1], plan.grid,
                channels=plan.padded_channels, raw="error_bound" in kw)
        (h, s, o), self._dev_state = _planned_scan(
            plan, pt, state=self._dev_state, valid=valid, **kw)
        h, s, o = (v.cpu().numpy() for v in (h, s, o))
        return [(h[ci], s[ci], o[ci]) for ci in range(self._C)]

    # ------------------------------------------------- adaptive mode selection
    def _channel_kw(self, ci: int) -> dict:
        """Encode parameters of channel ``ci`` under its current codec
        variant (adaptive sessions)."""
        cdc0, cdc = self.codec, self._codecs[ci]
        kw = dict(num_dict=cdc0.num_dict, d_crit=float(self._d_crit[ci]),
                  rel_tol=float(cdc0.rel_tol), use_minmax=cdc0.use_minmax,
                  use_ks=cdc0.use_ks)
        if cdc.error_bound is not None:
            kw["error_bound"] = float(cdc.error_bound)
            kw["error_cumulative"] = cdc.mode == "delta"
        return kw

    def _decide_adaptive(self, payloads):
        """Per-channel decisions under per-channel codec variants: one
        mixed-mode scan when the matcher has a masked variant (one dispatch
        and one host sync per feed), else the per-channel loop."""
        cdc0 = self.codec
        if cdc0.backend == "numpy":
            from .npref import encode_decisions_np, np_init_state
            if self._np_states is None:
                self._np_states = [np_init_state(cdc0.num_dict)
                                   for _ in range(self._C)]
            return [encode_decisions_np(payloads[ci],
                                        state=self._np_states[ci],
                                        **self._channel_kw(ci))[0]
                    for ci in range(self._C)]
        if self._mixed is None and not self._mixed_disabled:
            # a plan always takes the batched arm (its matcher was checked)
            force_loop = (os.environ.get(_ADAPTIVE_LOOP_ENV)
                          and self.plan is None)
            m = None if force_loop else _mixed_matcher_name(cdc0)
            if m is None:
                self._mixed_disabled = True
            else:
                self._mixed = MixedCohort(
                    cdc0.num_dict,
                    (self._C if self.plan is None
                     else self.plan.padded_channels),
                    rel_tol=float(cdc0.rel_tol),
                    use_minmax=cdc0.use_minmax, use_ks=cdc0.use_ks,
                    error_bound=cdc0.error_bound, matcher=m,
                    device=cdc0.torch_device, plan=self.plan)
        if self._mixed is None:
            return self._decide_adaptive_loop(payloads)
        dec = self._mixed.decide([
            (ci, np.asarray(payloads[ci]), float(self._d_crit[ci]),
             self._codecs[ci].mode == "delta",
             self._codecs[ci].error_bound is not None)
            for ci in range(self._C)])
        return [dec[ci] for ci in range(self._C)]

    def _decide_adaptive_loop(self, payloads):
        """The per-channel arm: one scan per channel (on ``"cuda"`` one
        static K1 launch each, or the codec's matcher), all issued before
        the one host sync."""
        from .encoder import encode_decisions, init_state
        cdc0 = self.codec
        outs = []
        for ci in range(self._C):
            kw = self._channel_kw(ci)
            kw["matcher"] = cdc0.matcher or (
                "fused" if cdc0.backend == "cuda" else None)
            pt = torch.as_tensor(payloads[ci], dtype=torch.float32,
                                 device=cdc0.torch_device)
            if self._adapt_states[ci] is None:
                self._adapt_states[ci] = init_state(
                    cdc0.num_dict, pt.shape[-1], device=pt.device,
                    raw="error_bound" in kw)
            out, self._adapt_states[ci] = encode_decisions(
                pt, state=self._adapt_states[ci], **kw)
            _M_DISPATCH["adaptive_loop"].inc()
            outs.append(out)
        _M_COHORT.observe(float(self._C))
        return [tuple(v.cpu().numpy() for v in out) for out in outs]

    def _apply_switch(self, ci: int, ev) -> None:
        """Commit an accepted selector switch: swap the channel's codec
        variant, scale its threshold, drop its dictionary and restart its
        segment chain (the next segment is ``cont=False``, so decoders take
        it as a fresh section)."""
        cdc = self.codec if ev.new_mode == self.codec.mode \
            else dataclasses.replace(self.codec, mode=ev.new_mode)
        self._codecs[ci] = cdc
        self._d_crit[ci] = float(cdc.d_crit) * float(ev.new_scale)
        self._started[ci] = False
        if self._np_states is not None:
            from .npref import np_init_state
            self._np_states[ci] = np_init_state(self.codec.num_dict)
        self._adapt_states[ci] = None
        if self._mixed is not None:
            self._mixed.reset_lane(ci)
        st = self._stats[ci]
        st.mode_switches += 1
        st.events.append(ev.as_dict())
        _M["mode_switches"].inc()
        obs.event("encode.mode_switch", attrs={"channel": ci,
                                               **ev.as_dict()})

    def _feed_adaptive(self, chunk):
        if self._finished:
            raise RuntimeError("session already finished")
        arr = np.asarray(chunk)
        arr2 = arr[None, :] if self.channels is None else arr
        if arr2.ndim != 2 or arr2.shape[0] != self._C:
            want = "1-D" if self.channels is None else f"(C={self._C}, m)"
            raise ValueError(f"expected {want} chunk, got {arr.shape}")
        # switches apply at the feed boundary, from the statistics of the
        # previous feeds: a segment never changes transform mid-flight
        for ci in range(self._C):
            ev = self._selectors[ci].decide(self._stats[ci].blocks)
            if ev is not None:
                self._apply_switch(ci, ev)
        for ci in range(self._C):
            self._selectors[ci].observe(arr2[ci])
        prep = self.prepare(chunk)
        if prep is None:
            empty = [b""] * self._C
            return empty[0] if self.channels is None else empty
        outs = self.commit(prep, self._decide_adaptive(prep.payloads))
        return outs[0] if self.channels is None else outs

    def _make_header(self, nb: int, tail: np.ndarray, more: bool,
                     ci: int) -> StreamHeader:
        cdc = self._codecs[ci]
        return StreamHeader(
            mode=cdc.mode_id, block_size=cdc.block_size,
            num_dict=cdc.num_dict, max_count=cdc.max_count,
            dtype=self.dtype, value_range=cdc.value_range, n_blocks=nb,
            tail=tail, more=more, cont=self._started[ci],
            error_bounded=cdc.error_bound is not None)

    def _emit(self, ci, raw, payload, bases, hit, slot, ovw, tail, more):
        header = self._make_header(len(raw), tail, more, ci)
        seg = stream_mod.assemble_stream(header, raw, payload, bases,
                                         hit, slot, ovw)
        self._started[ci] = True
        st = self._stats[ci]
        st.bytes_out += len(seg)
        st.segments += 1
        _M["bytes_out"].inc(len(seg))
        _M["segments"].inc()
        if self._writer is not None:
            self._writer.append(seg, channel=ci)
        return seg

    def _empty(self, ci: int):
        cdc = self._codecs[ci]
        raw = np.zeros((0, cdc.block_size), dtype=self.dtype)
        payload = np.zeros((0, cdc._lem_n()), dtype=self.dtype)
        bases = None if cdc.mode == "std" else np.zeros(0, self.dtype)
        z = np.zeros(0, dtype=np.int32)
        return raw, payload, bases, z.astype(bool), z, z.astype(bool)

    # ------------------------------------------------------------ public API
    def prepare(self, chunk, transform: bool = True
                ) -> Optional[PreparedChunk]:
        """Stage a chunk host-side: buffer the sample tails, cut complete
        blocks and apply the codec transform.  Returns ``None`` when no
        full block completed.  ``feed`` is ``prepare`` + decide +
        ``commit``.  ``transform=False`` leaves the transform to the
        caller (a coalescer that transforms its whole flush on the
        device), which fills ``payloads`` and ``bases`` before
        ``commit``."""
        if self._finished:
            raise RuntimeError("session already finished")
        arr = np.asarray(chunk)
        if self.channels is None:
            if arr.ndim != 1:
                raise ValueError("single-channel session feeds 1-D chunks")
            arr = arr[None, :]
        elif arr.ndim != 2 or arr.shape[0] != self._C:
            raise ValueError(f"expected (C={self._C}, m) chunk, got {arr.shape}")
        if arr.dtype != self.dtype:
            arr = arr.astype(self.dtype)

        B = self.codec.block_size
        joined = [np.concatenate([self._tails[ci], arr[ci]])
                  for ci in range(self._C)]
        nb = len(joined[0]) // B
        self._tails = [j[nb * B:] for j in joined]
        for ci in range(self._C):
            self._stats[ci].bytes_in += arr[ci].nbytes
        _M["bytes_in"].inc(arr.nbytes)
        if nb == 0:
            return None
        blocks = np.stack([j[: nb * B].reshape(nb, B) for j in joined])
        if not transform:
            return PreparedChunk(blocks, None, [None] * self._C, nb)
        payloads, bases = [], []
        for ci in range(self._C):
            p, b = self._codecs[ci]._transform(blocks[ci])
            payloads.append(p)
            bases.append(b)
            if b is not None:
                _M_TRANSFORM["host"].inc(nb)
        # adaptive channels may differ in payload width, so they stay a
        # ragged list; the static path stacks them for the batched scan
        stacked = payloads if self.adaptive else np.stack(payloads)
        return PreparedChunk(blocks, stacked, bases, nb)

    def commit(self, prep: PreparedChunk, decisions) -> List[bytes]:
        """Apply per-channel decision triples for a prepared chunk: update
        stats and emit (or buffer) each channel's segment.  Always returns
        a per-channel list."""
        outs = []
        total_hits = 0
        for ci in range(self._C):
            hit, slot, ovw = decisions[ci]
            st = self._stats[ci]
            st.blocks += prep.nb
            n_hits = int(np.sum(hit))
            st.hits += n_hits
            total_hits += n_hits
            if self.emit_segments:
                outs.append(self._emit(
                    ci, prep.blocks[ci], prep.payloads[ci], prep.bases[ci],
                    hit, slot, ovw, tail=np.zeros(0, dtype=self.dtype),
                    more=True))
            else:
                buf = self._buf[ci]
                buf["raw"].append(prep.blocks[ci])
                buf["payload"].append(prep.payloads[ci])
                if prep.bases[ci] is not None:
                    buf["bases"].append(prep.bases[ci])
                buf["hit"].append(hit)
                buf["slot"].append(slot)
                buf["ovw"].append(ovw)
                outs.append(b"")
        _M["blocks"].inc(prep.nb * self._C)
        _M["hits"].inc(total_hits)
        return outs

    def feed(self, chunk) -> Union[bytes, List[bytes]]:
        """Compress the next chunk; returns the emitted segment bytes (one
        ``bytes`` for single-channel sessions, a list for ``channels=C``).
        Samples not filling a block are buffered for the next feed/finish;
        an empty ``bytes`` means no full block completed yet."""
        if self.adaptive:
            return self._feed_adaptive(chunk)
        prep = self.prepare(chunk)
        if prep is None:
            empty = [b""] * self._C
            return empty[0] if self.channels is None else empty
        outs = self.commit(prep, self._decide(prep.payloads))
        return outs[0] if self.channels is None else outs

    def finish(self) -> Union[bytes, List[bytes]]:
        """Close the stream(s): emit the final segment carrying the sample
        tail (segment mode) or assemble the whole classic one-segment stream
        (``emit_segments=False``).

        With ``container=True`` the return value is instead ONE packed
        random-access container (``repro_torch.store``) holding every
        segment of every channel; the final per-channel segments go
        through its writer like any other."""
        if self._finished:
            raise RuntimeError("session already finished")
        self._finished = True
        outs = []
        for ci in range(self._C):
            buf = self._buf[ci]
            if self.emit_segments or not buf["raw"]:
                raw, payload, bases, hit, slot, ovw = self._empty(ci)
            else:
                raw = np.concatenate(buf["raw"])
                payload = np.concatenate(buf["payload"])
                bases = (np.concatenate(buf["bases"])
                         if buf["bases"] else None)
                hit = np.concatenate(buf["hit"])
                slot = np.concatenate(buf["slot"])
                ovw = np.concatenate(buf["ovw"])
            outs.append(self._emit(ci, raw, payload, bases, hit, slot, ovw,
                                   tail=self._tails[ci], more=False))
        if self._writer is not None:
            return self._writer.finalize()
        return outs[0] if self.channels is None else outs

    @property
    def stats(self) -> Union[SessionStats, List[SessionStats]]:
        return self._stats[0] if self.channels is None else list(self._stats)
