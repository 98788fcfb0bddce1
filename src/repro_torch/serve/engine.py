"""LM serving: prefill and batched greedy or sampled decode.

The counterpart of ``repro/serve/engine.py``'s ``serve_step``,
``prefill_step`` and ``ServeEngine`` for every ported family.  Every decode
step runs K4 once per self-attention layer (none for RWKV6).

``FlushPolicy`` is the serving layer's shared micro-batching knob: the
compression services (``serve.compress``) accumulate per-client payloads
and cut one padded device batch when the policy trips.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import lm
from ..models.common import ModelConfig
from ..models.layers import unembed

__all__ = ["FlushPolicy", "serve_step", "prefill_step", "ServeEngine"]


@dataclass(frozen=True)
class FlushPolicy:
    """When a coalescer should stop accumulating and cut a device batch.

    ``max_batch_blocks`` bounds the padded scan length; ``max_batch_streams``
    bounds how many clients wait on one dispatch (tail latency);
    ``max_age_s`` is the latency deadline -- a batch flushes once its
    oldest staged payload has waited this long, however little has
    accumulated.  Any threshold trips a flush; callers may always flush
    earlier (shutdown).

    ``pipeline_depth`` bounds how many flushed batches a pipelined
    coalescer (``serve.pipeline``) holds in flight: 1 alternates plan and
    reconstruct (a flush returns its own batch's answers); 2 plans batch
    N+1 on the host while batch N reconstructs, and a flush returns the
    previous batch's answers (``drain()`` collects the rest).

    The policy is pure: coalescers measure the age with their own
    (injectable) clock and pass it in.
    """

    max_batch_blocks: int = 4096
    max_batch_streams: int = 256
    max_age_s: Optional[float] = None
    pipeline_depth: int = 1

    def __post_init__(self):
        if self.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")

    def with_updates(self, **changes) -> "FlushPolicy":
        """A copy with the given knobs replaced; the policy itself stays
        frozen and hashable."""
        return dataclasses.replace(self, **changes)

    def as_dict(self) -> dict:
        """JSON-ready knob dump."""
        return {"max_batch_blocks": self.max_batch_blocks,
                "max_batch_streams": self.max_batch_streams,
                "max_age_s": self.max_age_s,
                "pipeline_depth": self.pipeline_depth}

    def should_flush(self, n_streams: int, n_blocks: int,
                     age_s: Optional[float] = None) -> bool:
        if (self.max_age_s is not None and age_s is not None
                and age_s >= self.max_age_s and (n_streams or n_blocks)):
            return True
        return (n_streams >= self.max_batch_streams
                or n_blocks >= self.max_batch_blocks)


def serve_step(params, cache: lm.DecodeCache, tokens, cfg: ModelConfig):
    """One decode step: tokens (B,1) -> (logits (B,1,V), cache)."""
    return lm.decode_step(params, cache, tokens, cfg)


def prefill_step(params, tokens, cfg: ModelConfig, memory=None):
    """Full-prompt forward -> float32 logits (B,1,V) of the last position.
    ``memory``: the image embeddings (vlm) or encoder output (audio)."""
    x, _ = lm.forward_hidden(params, tokens, cfg, memory)
    return unembed(params["embed"], x[:, -1:, :], cfg)


@dataclass
class ServeEngine:
    """Static-batch decode loop over ``params`` (``models.lm`` layout) on
    ``device`` (default the card; the parameters must already be there).
    ``memory_len`` sizes the cross-attention caches of the vlm and audio
    families (``lm.init_cache``); as in the reference, they hold zeros."""
    cfg: ModelConfig
    params: Any
    max_seq: int = 2048
    memory_len: int = 0
    temperature: float = 0.0
    device: DeviceLike = None
    stats: Dict[str, float] = field(default_factory=dict, init=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        where = self.params["embed"]["table"].device
        if where.type != self.device.type:
            raise ValueError(f"parameters on {where}, engine on "
                             f"{self.device}")

    def generate(self, prompts: np.ndarray, num_tokens: int,
                 seed: int = 0) -> np.ndarray:
        """prompts (B, P) int -> (B, num_tokens) int32 greedy or sampled
        tokens.

        Prefill runs through the decode path token by token, as the
        reference's does.  Greedy decoding takes the first maximal logit,
        as ``jnp.argmax`` does.  With ``temperature > 0`` tokens are drawn
        from ``softmax(logits / temperature)`` with a ``torch.Generator``
        seeded by ``seed``: deterministic for a seed, but not the
        reference's ``jax.random.categorical`` bits.

        Afterwards ``stats`` holds the host seconds of the prefill (ending
        in a device sync) and of the decode (ending when the tokens reach
        the host), and the tokens of each."""
        prompts = np.asarray(prompts)
        B, P = prompts.shape
        t0 = time.perf_counter()
        cache = lm.init_cache(self.cfg, B, self.max_seq, self.memory_len,
                              device=self.device)
        toks = torch.as_tensor(prompts, dtype=torch.int64).to(self.device)
        logits = None
        for t in range(P):
            logits, cache = serve_step(self.params, cache,
                                       toks[:, t:t + 1], self.cfg)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        gen = None
        if self.temperature > 0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        out = []
        for _ in range(num_tokens):
            last = logits[:, -1]
            if self.temperature > 0:
                probs = torch.softmax(last / self.temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen)
            else:
                tok = torch.argmax(last, dim=-1, keepdim=True)
            out.append(tok)
            logits, cache = serve_step(self.params, cache, tok, self.cfg)
        tokens = (torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
                  if out else np.zeros((B, 0), dtype=np.int32))
        self.stats = {"prefill_s": t1 - t0,
                      "decode_s": time.perf_counter() - t1,
                      "prefill_tokens": B * P,
                      "generated_tokens": B * num_tokens}
        return tokens
