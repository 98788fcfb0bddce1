"""User-facing IDEALEM codec: orchestrates transform -> decisions -> stream.

One-shot:

>>> codec = IdealemCodec(mode="std", block_size=32, num_dict=255, alpha=0.01)
>>> blob = codec.encode(x)            # x: 1-D numpy float array
>>> y = codec.decode(blob)            # same length, statistically similar
>>> codec.compression_ratio(x, blob)

Streaming (chunked / multi-channel) goes through ``IdealemSession``, which
keeps the FIFO dictionary alive between chunks:

>>> s = codec.session()               # or codec.session(channels=C)
>>> parts = [s.feed(chunk) for chunk in chunks] + [s.finish()]
>>> y = codec.decode(b"".join(parts))

Encode backends: ``"cuda"`` (the hand-written fused scan kernel, default),
``"torch"`` (the plain tensor scan) and ``"numpy"`` (the sequential
early-exit reference); all three are decision-identical.  On the tensor
backends ``matcher=`` picks the scan instead: ``"reference"``, ``"ops"``
(the hand-written dict_match kernel plus the tensor step), ``"fused"`` or
``"auto"`` (measured).  Decode backends are ``core.decode.BACKENDS``.  Both
run on ``device`` (default ``"cuda"``, an error when no GPU is present);
``device="cpu"`` runs the kernels' plain versions on the host.

Error-bounded mode (``error_bound=t`` or ``error_bound_rel``): every
decoded sample differs from its original by at most ``t`` (circular
distance when ``value_range`` wraps); would-be hits that break the bound
become misses and the decode skips the hit permutation.

Adaptive mode selection (``adaptive=True``, tuned by ``selector``) is
streaming-only: a session switches each channel's transform and threshold
at segment restarts (``core.session``, ``core.select``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..api import BACKENDS, CodecConfig
from ..device import resolve_device
from . import stream as stream_mod
from .encoder import MATCHERS
from .ks import critical_distance
from .select import SelectorConfig
from .session import IdealemSession
from .stream import MODE_DELTA, MODE_RESIDUAL, MODE_STD
from .transforms import np_wrap_centered

__all__ = ["IdealemCodec", "ENCODE_BACKENDS"]

_MODES = {"std": MODE_STD, "residual": MODE_RESIDUAL, "delta": MODE_DELTA}

ENCODE_BACKENDS = BACKENDS


@dataclass
class IdealemCodec:
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
    # encode matcher for the tensor backends: None keeps the backend default
    # (torch -> reference scan, cuda -> fused kernel), or one of
    # "reference" | "ops" | "fused" | "auto" (measured, see core.tuning)
    matcher: Optional[str] = None
    decode_seed: int = 0
    decode_backend: str = "cuda"
    device: str = "cuda"
    # error-bounded mode: a would-be hit whose pointwise reconstruction
    # error would exceed the bound is demoted to a miss, and hit decode
    # skips the exchangeability permutation, so max|x - x_hat| <=
    # error_bound on every sample (circular metric when value_range wraps).
    # error_bound_rel is the bound as a fraction of the value_range width,
    # resolved to an absolute error_bound here.
    error_bound: Optional[float] = None
    error_bound_rel: Optional[float] = None
    # adaptive per-channel mode selection (core.select): streaming-only --
    # sessions switch transform/threshold at segment restarts
    adaptive: bool = False
    selector: Optional[SelectorConfig] = None
    d_crit: float = field(init=False)
    torch_device: torch.device = field(init=False)

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {list(_MODES)}")
        if self.backend not in ENCODE_BACKENDS:
            raise ValueError(f"backend must be one of {ENCODE_BACKENDS}")
        if self.decode_backend not in BACKENDS:
            raise ValueError(f"decode_backend must be one of {BACKENDS}")
        if self.matcher is not None and \
                self.matcher not in MATCHERS + ("auto",):
            raise ValueError(f"matcher must be None or one of "
                             f"{MATCHERS + ('auto',)}")
        if not (1 <= self.num_dict <= 255):
            raise ValueError("num_dict must be in [1, 255]")
        if not (1 <= self.max_count <= 255):
            raise ValueError("max_count must be in [1, 255]")
        if self.block_size < 2:
            raise ValueError("block_size must be >= 2")
        if self.error_bound_rel is not None:
            if self.value_range is None:
                raise ValueError("error_bound_rel requires value_range")
            self.error_bound = float(self.error_bound_rel) * (
                self.value_range[1] - self.value_range[0])
        if self.error_bound is not None and not self.error_bound > 0:
            raise ValueError("error_bound must be positive")
        n = self._lem_n()
        self.d_crit = critical_distance(self.alpha, n, n)
        self.torch_device = resolve_device(self.device)

    # ------------------------------------------------------------- internals
    @property
    def mode_id(self) -> int:
        return _MODES[self.mode]

    def _lem_n(self) -> int:
        return self.block_size if self.mode == "std" else self.block_size - 1

    def _transform(self, blocks: np.ndarray):
        """Returns (payload for LEM+stream, bases or None). Host-side."""
        if self.mode == "std":
            return blocks, None
        bases = blocks[:, 0].copy()
        if self.mode == "residual":
            t = blocks[:, 1:] - bases[:, None]
        else:
            t = np.diff(blocks, axis=1)
        if self.value_range is not None:
            t = np_wrap_centered(t, *self.value_range)
        return t, bases

    # ------------------------------------------------------------ public API
    @classmethod
    def from_config(cls, config: Union[CodecConfig, dict],
                    device: str = "cuda") -> "IdealemCodec":
        """Build a codec from one :class:`repro_torch.api.CodecConfig` (or
        its JSON dict form).  ``device`` is an in-process choice and not
        part of the config."""
        if isinstance(config, dict):
            config = CodecConfig.from_json(config)
        return cls(device=device, **config.kwargs())

    @property
    def config(self) -> CodecConfig:
        """The frozen :class:`repro_torch.api.CodecConfig` of this codec.

        Round-trip stable: ``IdealemCodec.from_config(codec.config)``
        makes identical decisions and bytes.  ``error_bound_rel`` is
        resolved once at construction, so the config carries the absolute
        ``error_bound``; a custom adaptive ``selector`` and the ``device``
        are in-process knobs and are not captured."""
        return CodecConfig(
            mode=self.mode, block_size=self.block_size,
            num_dict=self.num_dict, alpha=self.alpha, rel_tol=self.rel_tol,
            use_minmax=self.use_minmax, use_ks=self.use_ks,
            max_count=self.max_count, value_range=self.value_range,
            backend=self.backend, matcher=self.matcher,
            decode_seed=self.decode_seed, decode_backend=self.decode_backend,
            error_bound=self.error_bound, adaptive=self.adaptive)

    def session(self, channels: Optional[int] = None,
                emit_segments: bool = True, dtype=np.float64, plan=None,
                container: bool = False) -> IdealemSession:
        """Open a resumable streaming session with this configuration.
        ``container=True`` makes ``finish()`` return one indexed
        random-access container (``repro_torch.store``) over all channels
        instead of the final segments.  ``plan``
        (``repro_torch.launch.encode_plan.make_encode_plan``) spreads the
        scan over the plan's devices, with the same bytes."""
        return IdealemSession(self, channels=channels,
                              emit_segments=emit_segments, dtype=dtype,
                              plan=plan, container=container)

    def encode(self, x: np.ndarray) -> bytes:
        """One-shot encode: a single-feed session assembled as one segment."""
        x = np.ascontiguousarray(x)
        if self.adaptive:
            raise ValueError("adaptive codecs are streaming-only; use "
                             "codec.session() and feed chunks")
        if x.ndim != 1:
            raise ValueError(
                "IdealemCodec.encode compresses 1-D arrays; use "
                "codec.session(channels=C) for batched multi-channel streams")
        s = IdealemSession(self, emit_segments=False, dtype=x.dtype)
        s.feed(x)
        return s.finish()

    def decode(self, blob: bytes, backend: Optional[str] = None) -> np.ndarray:
        """Decode a stream; ``backend`` overrides the codec's
        ``decode_backend`` (all backends are byte-identical)."""
        return stream_mod.decode_stream(
            blob, seed=self.decode_seed,
            backend=backend or self.decode_backend, device=self.torch_device)

    @staticmethod
    def compression_ratio(x: np.ndarray, blob: bytes) -> float:
        return x.nbytes / len(blob)

    def encode_stats(self, x: np.ndarray) -> dict:
        blob = self.encode(x)
        _, events = stream_mod.parse_stream(blob)
        hits = sum(1 for e in events if e["kind"] == "hit")
        return {
            "ratio": self.compression_ratio(x, blob),
            "bytes": len(blob),
            "blocks": len(events),
            "hits": hits,
            "hit_rate": hits / max(len(events), 1),
        }
