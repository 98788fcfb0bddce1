"""The dense decoder stack of the LM serve path.

The counterpart of ``repro/models/lm.py`` for the dense family (granite,
glm4, stablelm; ``local_global_ratio`` and ``sliding_window`` are kept,
since :func:`decode_attention` handles windows).  The reference stacks each
stage's layers and runs them with ``lax.scan``; here the parameters are a
list with one dict per layer, in the order the scan visits them, and the
scan is a Python loop.  ``models.convert.params_from_jax`` splits the
reference's stacked layout into this one.

Other families (moe, ssm, hybrid, vlm, audio) raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..device import resolve_device
from .attention import (KVCache, attention, decode_attention, init_attention,
                        init_kv_cache, ring_valid, rope_angles)
from .common import UNPORTED, ModelConfig
from .layers import (embed, init_embed, init_mlp, init_rmsnorm, mlp, rmsnorm,
                     unembed)

__all__ = ["stage_plan", "layer_kinds", "init_params", "forward_hidden",
           "DecodeCache", "init_cache", "decode_step"]


def stage_plan(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """(pattern, repeats) per stage, as the reference plans the dense
    family."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name!r} is a {cfg.family!r} model; the port serves the "
            f"dense family only: see {UNPORTED}")
    L = cfg.num_layers
    if cfg.local_global_ratio:
        k = cfg.local_global_ratio
        reps, rem = divmod(L, k + 1)
        plan = []
        if reps:
            plan.append((("attn_local",) * k + ("attn_global",), reps))
        if rem:
            plan.append((("attn_local",), rem))
        return plan
    return [(("attn",), L)]


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The kind of every layer, in order: each stage's pattern repeated."""
    return [kind for pattern, reps in stage_plan(cfg)
            for _ in range(reps) for kind in pattern]


def _kind_window(kind: str, cfg: ModelConfig) -> Optional[int]:
    if kind == "attn_local":
        return cfg.local_window
    if kind == "attn":
        return cfg.sliding_window
    return None


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Dict[str, Any]:
    """Random parameters drawn from ``generator`` on ``device`` (default
    the card): ``{"embed", "final_norm", "layers": [one dict per layer]}``.
    ``device="meta"`` gives the shapes without memory."""
    dev = resolve_device(device)
    kw = dict(generator=generator, device=dev)
    params: Dict[str, Any] = {
        "embed": init_embed(cfg, **kw),
        "final_norm": init_rmsnorm(cfg.d_model, cfg.param_dtype, dev)}
    params["layers"] = [
        {"norm1": init_rmsnorm(cfg.d_model, cfg.param_dtype, dev),
         "attn": init_attention(cfg, **kw),
         "norm2": init_rmsnorm(cfg.d_model, cfg.param_dtype, dev),
         "mlp": init_mlp(cfg, **kw)}
        for _ in layer_kinds(cfg)]
    return params


def forward_hidden(params, tokens, cfg: ModelConfig):
    """tokens (B,S) -> hidden (B,S,d) after the final norm, aux loss (0 for
    the dense family)."""
    x = embed(params["embed"], tokens, cfg)
    for kind, p in zip(layer_kinds(cfg), params["layers"]):
        x = x + attention(p["attn"], rmsnorm(p["norm1"], x, cfg.norm_eps),
                          cfg, causal=True, window=_kind_window(kind, cfg))
        x = x + mlp(p["mlp"], rmsnorm(p["norm2"], x, cfg.norm_eps), cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


class DecodeCache(NamedTuple):
    layers: Tuple[KVCache, ...]  # one ring cache per layer


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> DecodeCache:
    dev = resolve_device(device)
    return DecodeCache(tuple(
        init_kv_cache(cfg, batch, max_seq, _kind_window(kind, cfg),
                      device=dev)
        for kind in layer_kinds(cfg)))


def decode_step(params, cache: DecodeCache, tokens, cfg: ModelConfig, *,
                backend: str = "cuda"):
    """tokens (B,1) -> (logits (B,1,V) float32, cache).  The caches are
    updated in place (see ``models.attention``); the returned
    :class:`DecodeCache` carries the new lengths.  ``backend="torch"``
    takes the plain attention core instead of K4, to compare the two.

    Every layer's cache holds the same number of tokens, so the RoPE
    angles of the new position are built once a step, and its ring mask
    once for each distinct (cache length, window)."""
    x = embed(params["embed"], tokens, cfg)
    B, pos = x.shape[0], cache.layers[0].length
    angles = rope_angles(torch.full((1,), pos, dtype=torch.int32,
                                    device=x.device), cfg.hd, cfg.rope_theta)
    masks = {}
    new = []
    for kind, p, c in zip(layer_kinds(cfg), params["layers"], cache.layers):
        window, C = _kind_window(kind, cfg), c.k.shape[1]
        if (C, window) not in masks:
            masks[C, window] = ring_valid(pos, C, window,
                                          x.device).expand(B, C)
        y, c = decode_attention(p["attn"],
                                rmsnorm(p["norm1"], x, cfg.norm_eps), c, cfg,
                                window=window, backend=backend,
                                valid=masks[C, window], angles=angles)
        x = x + y
        x = x + mlp(p["mlp"], rmsnorm(p["norm2"], x, cfg.norm_eps), cfg)
        new.append(c)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x, cfg), DecodeCache(tuple(new))
