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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, List, NamedTuple, Optional, Union

import numpy as np
import torch

from . import stream as stream_mod
from .stream import StreamHeader

if TYPE_CHECKING:  # pragma: no cover
    from .idealem import IdealemCodec

__all__ = ["IdealemSession", "PreparedChunk", "SessionStats"]


class PreparedChunk(NamedTuple):
    """Host-side staging of one feed: complete blocks cut from the chunk
    (tails already re-buffered) with their transforms applied."""

    blocks: np.ndarray            # (C, nb, B) raw values
    payloads: np.ndarray          # (C, nb, n_lem) transformed
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

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.blocks, 1)

    def as_dict(self) -> dict:
        return {
            "blocks": self.blocks, "hits": self.hits,
            "hit_rate": self.hit_rate, "segments": self.segments,
            "bytes_in": self.bytes_in, "bytes_out": self.bytes_out,
            "ratio": self.bytes_in / max(self.bytes_out, 1),
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
        if plan is not None:
            raise ValueError("encode plans (sharded sessions) are not ported "
                             "yet (ROADMAP Queue 1 item 9)")
        if container:
            raise ValueError("container output is not ported yet (ROADMAP "
                             "Queue 1 item 7)")
        if channels is not None and channels < 1:
            raise ValueError("channels must be >= 1")
        self.codec = codec
        self.channels = channels
        self.emit_segments = emit_segments
        self.dtype = np.dtype(dtype)
        C = self._C = channels if channels is not None else 1
        self._tails = [np.zeros(0, dtype=self.dtype) for _ in range(C)]
        self._started = [False] * C  # any segment emitted yet (per channel)
        self._finished = False
        self._stats = [SessionStats() for _ in range(C)]
        self._dev_state = None   # batched DictState (torch / cuda backends)
        self._np_states = None   # list[NpDictState] (numpy backend)
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

    def _make_header(self, nb: int, tail: np.ndarray, more: bool,
                     ci: int) -> StreamHeader:
        cdc = self.codec
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
        return seg

    def _empty(self):
        cdc = self.codec
        raw = np.zeros((0, cdc.block_size), dtype=self.dtype)
        payload = np.zeros((0, cdc._lem_n()), dtype=self.dtype)
        bases = None if cdc.mode == "std" else np.zeros(0, self.dtype)
        z = np.zeros(0, dtype=np.int32)
        return raw, payload, bases, z.astype(bool), z, z.astype(bool)

    # ------------------------------------------------------------ public API
    def prepare(self, chunk) -> Optional[PreparedChunk]:
        """Stage a chunk host-side: buffer the sample tails, cut complete
        blocks and apply the codec transform.  Returns ``None`` when no
        full block completed.  ``feed`` is ``prepare`` + decide +
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
        if nb == 0:
            return None
        blocks = np.stack([j[: nb * B].reshape(nb, B) for j in joined])
        payloads, bases = [], []
        for ci in range(self._C):
            p, b = self.codec._transform(blocks[ci])
            payloads.append(p)
            bases.append(b)
        return PreparedChunk(blocks, np.stack(payloads), bases, nb)

    def commit(self, prep: PreparedChunk, decisions) -> List[bytes]:
        """Apply per-channel decision triples for a prepared chunk: update
        stats and emit (or buffer) each channel's segment.  Always returns
        a per-channel list."""
        outs = []
        for ci in range(self._C):
            hit, slot, ovw = decisions[ci]
            st = self._stats[ci]
            st.blocks += prep.nb
            st.hits += int(np.sum(hit))
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
        return outs

    def feed(self, chunk) -> Union[bytes, List[bytes]]:
        """Compress the next chunk; returns the emitted segment bytes (one
        ``bytes`` for single-channel sessions, a list for ``channels=C``).
        Samples not filling a block are buffered for the next feed/finish;
        an empty ``bytes`` means no full block completed yet."""
        prep = self.prepare(chunk)
        if prep is None:
            empty = [b""] * self._C
            return empty[0] if self.channels is None else empty
        outs = self.commit(prep, self._decide(prep.payloads))
        return outs[0] if self.channels is None else outs

    def finish(self) -> Union[bytes, List[bytes]]:
        """Close the stream(s): emit the final segment carrying the sample
        tail (segment mode) or assemble the whole classic one-segment stream
        (``emit_segments=False``)."""
        if self._finished:
            raise RuntimeError("session already finished")
        self._finished = True
        outs = []
        for ci in range(self._C):
            buf = self._buf[ci]
            if self.emit_segments or not buf["raw"]:
                raw, payload, bases, hit, slot, ovw = self._empty()
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
        return outs[0] if self.channels is None else outs

    @property
    def stats(self) -> Union[SessionStats, List[SessionStats]]:
        return self._stats[0] if self.channels is None else list(self._stats)
