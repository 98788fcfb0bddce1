"""Wire-typed public API of the port: the request/response types every
entry point shares, the reference package's wire types field for field.

In-process services and a network front end speak the same types, so
there is exactly one place where payload encoding, validation and defaults
live.

Every type round-trips through JSON (``to_json``/``from_json``): numpy
payloads travel as base64 of their raw little-endian bytes next to a
dtype tag, segment/container bytes as plain base64.  ``from_json``
validates strictly -- unknown keys and malformed fields raise
:class:`repro_torch.errors.ApiError` (protocol code ``bad_request``), never a
bare ``KeyError`` -- because these constructors face the network.

:class:`CodecConfig` is the one serializable description of a codec: the
frozen, hashable counterpart of ``IdealemCodec``'s keyword sprawl.
``IdealemCodec.from_config``/``.config`` round-trip it; plain kwargs keep
working unchanged.  Its ``backend`` and ``decode_backend`` take the port's
names (:data:`BACKENDS`, default ``"cuda"``); the device a codec runs on is
an in-process choice and is not part of the config.

Dependency-light by design: numpy + stdlib only (no ``torch`` import), so
clients can use the wire types without pulling the device stack.
"""
from __future__ import annotations

import base64
import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from .errors import ApiError

__all__ = [
    "BACKENDS",
    "CodecConfig",
    "CompressRequest",
    "FeedResult",
    "DecodeRangeRequest",
    "RangeResult",
    "encode_array",
    "decode_array",
    "encode_bytes",
    "decode_bytes",
]


#: The port's encode and decode backends: the host reference, the plain
#: tensor path and the hand-written kernels.
BACKENDS = ("numpy", "torch", "cuda")


# ------------------------------------------------------------ payload codecs
def encode_array(x: np.ndarray) -> dict:
    """1-D numpy array -> JSON-ready ``{"dtype", "b64"}`` document."""
    x = np.ascontiguousarray(x)
    return {"dtype": x.dtype.str, "b64": base64.b64encode(
        x.tobytes()).decode("ascii")}


def decode_array(doc: object, what: str = "array") -> np.ndarray:
    """Inverse of :func:`encode_array`; raises :class:`ApiError` on any
    malformed input (this constructor faces the network)."""
    if not isinstance(doc, dict) or "b64" not in doc or "dtype" not in doc:
        raise ApiError(f"{what}: expected {{'dtype', 'b64'}} object")
    try:
        dt = np.dtype(doc["dtype"])
        raw = base64.b64decode(doc["b64"], validate=True)
    except Exception as exc:
        raise ApiError(f"{what}: {exc}") from None
    if dt.itemsize == 0 or len(raw) % dt.itemsize:
        raise ApiError(f"{what}: {len(raw)} bytes is not a whole number "
                       f"of {dt.str} items")
    return np.frombuffer(raw, dtype=dt).copy()


def encode_bytes(b: bytes) -> str:
    return base64.b64encode(b).decode("ascii")


def decode_bytes(doc: object, what: str = "bytes") -> bytes:
    if not isinstance(doc, str):
        raise ApiError(f"{what}: expected base64 string")
    try:
        return base64.b64decode(doc, validate=True)
    except Exception as exc:
        raise ApiError(f"{what}: {exc}") from None


def _require(doc: dict, key: str, typ, what: str):
    if key not in doc:
        raise ApiError(f"{what}: missing field {key!r}")
    v = doc[key]
    if typ is float and isinstance(v, int):
        v = float(v)
    if typ is not None and not isinstance(v, typ):
        raise ApiError(f"{what}: field {key!r} must be {typ.__name__}, "
                       f"got {type(v).__name__}")
    return v


def _reject_unknown(doc: dict, known, what: str) -> None:
    extra = set(doc) - set(known)
    if extra:
        raise ApiError(f"{what}: unknown field(s) {sorted(extra)}")


# -------------------------------------------------------------- codec config
@dataclass(frozen=True)
class CodecConfig:
    """Frozen, JSON-serializable description of an ``IdealemCodec``.

    One value of this type pins every knob a codec instance needs --
    it IS the wire format for per-tenant codec configuration, and the
    hashable key under which a front end caches tenant codecs.
    ``repro_torch.core.IdealemCodec.from_config(cfg)`` builds the codec;
    ``codec.config`` gives the config back (round-trip stable: the codec
    resolves ``error_bound_rel`` to ``error_bound`` once, and the config
    carries the resolved absolute bound).

    The adaptive ``selector`` schedule is deliberately NOT part of this
    type: ``SelectorConfig`` defaults are pinned by ``adaptive=True``, and
    custom selector schedules are an in-process tuning surface, not a wire
    contract.
    """

    mode: str = "std"
    block_size: int = 32
    num_dict: int = 255
    alpha: float = 0.01
    rel_tol: float = 0.1
    use_minmax: bool = True
    use_ks: bool = True
    max_count: int = 255
    value_range: Optional[Tuple[float, float]] = None
    backend: str = "cuda"
    matcher: Optional[str] = None
    decode_seed: int = 0
    decode_backend: str = "cuda"
    error_bound: Optional[float] = None
    adaptive: bool = False

    def __post_init__(self):
        for knob in ("backend", "decode_backend"):
            if getattr(self, knob) not in BACKENDS:
                raise ApiError(f"CodecConfig: {knob} must be one of "
                               f"{BACKENDS}, got {getattr(self, knob)!r}")
        if self.value_range is not None:
            vr = tuple(float(v) for v in self.value_range)
            if len(vr) != 2:
                raise ApiError("CodecConfig: value_range must be (lo, hi)")
            object.__setattr__(self, "value_range", vr)

    def to_json(self) -> dict:
        """JSON-ready dict holding only the non-default knobs (a config
        serialized by an older client stays readable as defaults move)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v != f.default:
                out[f.name] = list(v) if isinstance(v, tuple) else v
        return out

    @classmethod
    def from_json(cls, doc: object) -> "CodecConfig":
        if doc is None:
            return cls()
        if not isinstance(doc, dict):
            raise ApiError("CodecConfig: expected object")
        names = {f.name for f in dataclasses.fields(cls)}
        _reject_unknown(doc, names, "CodecConfig")
        kw = dict(doc)
        if kw.get("value_range") is not None:
            vr = kw["value_range"]
            if (not isinstance(vr, (list, tuple)) or len(vr) != 2
                    or not all(isinstance(v, (int, float)) for v in vr)):
                raise ApiError("CodecConfig: value_range must be [lo, hi]")
            kw["value_range"] = tuple(float(v) for v in vr)
        try:
            return cls(**kw)
        except ApiError:
            raise
        except (TypeError, ValueError) as exc:
            raise ApiError(f"CodecConfig: {exc}") from None

    def kwargs(self) -> dict:
        """The ``IdealemCodec(**kwargs)`` form of this config."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


# ---------------------------------------------------------------- wire types
@dataclass(frozen=True, eq=False)
class CompressRequest:
    """Feed ``samples`` into open stream ``stream_id``.  ``samples`` is 1-D
    (wire streams are single-channel; batched multi-channel cohorts are an
    in-process shape)."""

    stream_id: str
    samples: np.ndarray

    def __post_init__(self):
        arr = np.asarray(self.samples)
        if arr.ndim != 1:
            raise ApiError("CompressRequest: samples must be 1-D")
        object.__setattr__(self, "samples", arr)

    def to_json(self) -> dict:
        return {"stream_id": self.stream_id,
                "samples": encode_array(self.samples)}

    @classmethod
    def from_json(cls, doc: object) -> "CompressRequest":
        if not isinstance(doc, dict):
            raise ApiError("CompressRequest: expected object")
        _reject_unknown(doc, ("stream_id", "samples"), "CompressRequest")
        return cls(
            stream_id=_require(doc, "stream_id", str, "CompressRequest"),
            samples=decode_array(_require(doc, "samples", None,
                                          "CompressRequest"),
                                 "CompressRequest.samples"))


@dataclass(frozen=True, eq=False)
class FeedResult:
    """One feed's (or close's) outcome: the emitted segment bytes plus the
    accounting delta this call produced.  ``segment`` may be empty (the
    samples joined a sub-block tail, or a coalesced stream staged them for
    a later flush); concatenating every returned segment of a stream
    yields the decodable stream."""

    stream_id: str
    segment: bytes = b""
    blocks: int = 0
    hits: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    final: bool = False

    def to_json(self) -> dict:
        return {"stream_id": self.stream_id,
                "segment": encode_bytes(self.segment),
                "blocks": self.blocks, "hits": self.hits,
                "bytes_in": self.bytes_in, "bytes_out": self.bytes_out,
                "final": self.final}

    @classmethod
    def from_json(cls, doc: object) -> "FeedResult":
        if not isinstance(doc, dict):
            raise ApiError("FeedResult: expected object")
        _reject_unknown(doc, ("stream_id", "segment", "blocks", "hits",
                              "bytes_in", "bytes_out", "final"),
                        "FeedResult")
        return cls(
            stream_id=_require(doc, "stream_id", str, "FeedResult"),
            segment=decode_bytes(doc.get("segment", ""),
                                 "FeedResult.segment"),
            blocks=_require(doc, "blocks", int, "FeedResult"),
            hits=_require(doc, "hits", int, "FeedResult"),
            bytes_in=_require(doc, "bytes_in", int, "FeedResult"),
            bytes_out=_require(doc, "bytes_out", int, "FeedResult"),
            final=bool(doc.get("final", False)))


@dataclass(frozen=True, eq=False)
class DecodeRangeRequest:
    """Range-decode blocks ``[start_block, stop_block)`` of a channel of
    an attached container.  ``request_id`` correlates the answer through
    batched serving."""

    store_id: str
    start_block: int
    stop_block: int
    channel: int = 0
    request_id: str = ""

    def __post_init__(self):
        if not (0 <= int(self.start_block) < int(self.stop_block)):
            raise ApiError(
                f"DecodeRangeRequest: bad range [{self.start_block}, "
                f"{self.stop_block})")

    def to_json(self) -> dict:
        return {"store_id": self.store_id,
                "start_block": int(self.start_block),
                "stop_block": int(self.stop_block),
                "channel": int(self.channel),
                "request_id": self.request_id}

    @classmethod
    def from_json(cls, doc: object) -> "DecodeRangeRequest":
        if not isinstance(doc, dict):
            raise ApiError("DecodeRangeRequest: expected object")
        _reject_unknown(doc, ("store_id", "start_block", "stop_block",
                              "channel", "request_id"), "DecodeRangeRequest")
        return cls(
            store_id=_require(doc, "store_id", str, "DecodeRangeRequest"),
            start_block=_require(doc, "start_block", int,
                                 "DecodeRangeRequest"),
            stop_block=_require(doc, "stop_block", int, "DecodeRangeRequest"),
            channel=int(doc.get("channel", 0)),
            request_id=str(doc.get("request_id", "")))


@dataclass(frozen=True, eq=False)
class RangeResult:
    """A range request's reconstructed samples."""

    request_id: str
    values: np.ndarray = field(default_factory=lambda: np.empty(0))

    def to_json(self) -> dict:
        return {"request_id": self.request_id,
                "values": encode_array(self.values)}

    @classmethod
    def from_json(cls, doc: object) -> "RangeResult":
        if not isinstance(doc, dict):
            raise ApiError("RangeResult: expected object")
        _reject_unknown(doc, ("request_id", "values"), "RangeResult")
        return cls(
            request_id=_require(doc, "request_id", str, "RangeResult"),
            values=decode_array(_require(doc, "values", None, "RangeResult"),
                                "RangeResult.values"))
