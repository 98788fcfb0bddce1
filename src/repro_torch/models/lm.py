"""Model assembly of the LM: heterogeneous layer stacks, the training loss
and the decode step.

The counterpart of ``repro/models/lm.py``.  A config maps to a *stage
plan*, a list of (pattern, repeats) where a pattern is a tuple of layer
kinds (zamba2's shared attention and six Mamba2 layers, the VLM's four
self-attention layers and a cross-attention layer).  The reference stacks
each stage's parameters and runs them with ``lax.scan``; here the
parameters are a list with one dict per layer, in the order the scan
visits them, and the scan is a Python loop.  ``models.convert.
params_from_jax`` splits the reference's stacked layout into this one.
Where the reference wraps each scanned repeat of a stage's pattern in
``jax.checkpoint`` (``cfg.remat``), the forward wraps each repeat (one
super-block of :func:`layer_kinds`) in ``torch.utils.checkpoint`` while
gradients are being taken.

Layer kinds:
  attn          self-attention + MLP (window = cfg.sliding_window if set)
  attn_local    sliding-window self-attention + MLP (cfg.local_window)
  attn_global   full self-attention + MLP
  enc_attn      bidirectional self-attention + MLP (encoder)
  dec_attn      causal self-attn + cross-attn(memory) + MLP (enc-dec decoder)
  moe_attn      self-attention + MoE FFN
  cross         cross-attention(memory) + MLP (VLM image layers)
  ssm           Mamba2 block
  shared_attn   zamba2's weight-shared attention block (params stored once,
                in ``params["shared"]``; its layers' entries are empty)
  rwkv          RWKV6 time-mix + channel-mix

Every self-attention decode (``attn*``, ``moe_attn``, ``shared_attn`` and
the self half of ``dec_attn``) runs K4 once a layer and step; the
cross-attention decode against the memory caches is plain PyTorch, as the
reference's ``_cross_decode`` is plain jnp.  As in the reference's serve
path, nothing writes the encoder output or image embeddings into the
cross caches: they hold zeros of ``memory_len`` positions.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..tree import tree_leaves
from .attention import (BACKENDS, KVCache, _repeat_kv, attention,
                        cross_attention, decode_attention, init_attention,
                        init_kv_cache, ring_valid, rope_angles)
from .common import ModelConfig, logical
from .layers import (embed, init_embed, init_mlp, init_rmsnorm, mlp, rmsnorm,
                     unembed)
from .moe import init_moe, moe_ffn
from .rwkv import (channel_mix_decode, channel_mix_forward, init_channel_mix,
                   init_rwkv_cache, init_time_mix, time_mix_decode,
                   time_mix_forward)
from .ssm import init_ssm, init_ssm_cache, ssm_decode, ssm_forward

__all__ = ["stage_plan", "layer_kinds", "init_params", "forward_hidden",
           "encode_frames", "lm_loss", "LOSS_CHUNK", "DecodeCache",
           "init_cache", "decode_step", "SELF_ATTN_KINDS"]

#: Positions a chunk of the loss: (B, LOSS_CHUNK, V) float32 logits at once.
LOSS_CHUNK = 1024

#: Kinds whose decode is one self-attention (one K4 launch) a step.
SELF_ATTN_KINDS = ("attn", "attn_local", "attn_global", "moe_attn",
                   "shared_attn", "dec_attn")


def stage_plan(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """(pattern, repeats) per stage, as the reference plans each family
    (a family it does not name is planned as dense)."""
    L = cfg.num_layers
    if cfg.family == "moe":
        return [(("moe_attn",), L)]
    if cfg.family == "ssm":
        return [(("rwkv",), L)]
    if cfg.family == "hybrid":
        k = cfg.attn_every or 6
        reps, rem = divmod(L, k)
        plan = []
        if reps:
            plan.append((("shared_attn",) + ("ssm",) * k, reps))
        if rem:
            plan.append((("ssm",), rem))
        return plan
    if cfg.family == "vlm":
        k = cfg.cross_attn_every or 5
        reps, rem = divmod(L, k)
        plan = []
        if reps:
            plan.append((("attn",) * (k - 1) + ("cross",), reps))
        if rem:
            plan.append((("attn",), rem))
        return plan
    if cfg.family == "audio":  # decoder side; the encoder is separate
        return [(("dec_attn",), L)]
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
    if kind in ("attn", "moe_attn", "shared_attn"):
        return cfg.sliding_window
    return None


# ---------------------------------------------------------------------- init


def _init_layer(kind: str, cfg: ModelConfig, **kw):
    dev = kw["device"]

    def n():
        return init_rmsnorm(cfg.d_model, cfg.param_dtype, dev)

    if kind in ("attn", "attn_local", "attn_global", "enc_attn",
                "shared_attn"):
        return {"norm1": n(), "attn": init_attention(cfg, **kw),
                "norm2": n(), "mlp": init_mlp(cfg, **kw)}
    if kind == "moe_attn":
        return {"norm1": n(), "attn": init_attention(cfg, **kw),
                "norm2": n(), "moe": init_moe(cfg, **kw)}
    if kind == "cross":
        return {"norm1": n(), "cross": init_attention(cfg, **kw, cross=True),
                "norm2": n(), "mlp": init_mlp(cfg, **kw)}
    if kind == "dec_attn":
        return {"norm1": n(), "attn": init_attention(cfg, **kw),
                "norm_x": n(), "cross": init_attention(cfg, **kw, cross=True),
                "norm2": n(), "mlp": init_mlp(cfg, **kw)}
    if kind == "ssm":
        return {"norm1": n(), "ssm": init_ssm(cfg, **kw)}
    if kind == "rwkv":
        return {"norm1": n(), "tm": init_time_mix(cfg, **kw),
                "norm2": n(), "cm": init_channel_mix(cfg, **kw)}
    raise ValueError(kind)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None, masters: bool = False) -> Dict[str, Any]:
    """Random parameters drawn from ``generator`` on ``device`` (default
    the card): ``{"embed", "final_norm", "layers": [one dict per layer]}``,
    with ``"shared"`` (zamba2's attention block, stored once) and
    ``"encoder": {"layers", "norm"}`` (whisper) where the family has them.
    ``device="meta"`` gives the shapes without memory.

    The serve layout holds the projections in ``cfg.dtype``;
    ``masters=True`` holds every leaf in ``cfg.param_dtype`` (the trainer's
    float32 masters, as the reference's parameters are), the same draws
    before the cast.  The forward casts each leaf to the compute dtype at
    its use, so both layouts give the same numbers."""
    dev = resolve_device(device)
    if masters:
        cfg = cfg.replace(dtype=cfg.param_dtype)
    kw = dict(generator=generator, device=dev)
    params: Dict[str, Any] = {
        "embed": init_embed(cfg, **kw),
        "final_norm": init_rmsnorm(cfg.d_model, cfg.param_dtype, dev)}
    kinds = layer_kinds(cfg)
    params["layers"] = [{} if kind == "shared_attn"
                        else _init_layer(kind, cfg, **kw) for kind in kinds]
    if "shared_attn" in kinds:
        params["shared"] = _init_layer("shared_attn", cfg, **kw)
    if cfg.encoder_layers:
        params["encoder"] = {
            "layers": [_init_layer("enc_attn", cfg, **kw)
                       for _ in range(cfg.encoder_layers)],
            "norm": init_rmsnorm(cfg.d_model, cfg.param_dtype, dev)}
    return params


def _layer_params(params, kind: str, p):
    return params["shared"] if kind == "shared_attn" else p


# ------------------------------------------------------------------ forward


def _apply_layer(kind, p, x, cfg, memory):
    """One layer of the forward (prefill).  Returns (x, aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    eps = cfg.norm_eps
    if kind in ("attn", "attn_local", "attn_global", "enc_attn",
                "shared_attn"):
        x = x + attention(p["attn"], rmsnorm(p["norm1"], x, eps), cfg,
                          causal=kind != "enc_attn",
                          window=_kind_window(kind, cfg))
        x = x + mlp(p["mlp"], rmsnorm(p["norm2"], x, eps), cfg)
    elif kind == "moe_attn":
        x = x + attention(p["attn"], rmsnorm(p["norm1"], x, eps), cfg,
                          causal=True, window=_kind_window(kind, cfg))
        y, aux = moe_ffn(p["moe"], rmsnorm(p["norm2"], x, eps), cfg)
        x = x + y
    elif kind == "cross":
        x = x + cross_attention(p["cross"], rmsnorm(p["norm1"], x, eps),
                                memory, cfg)
        x = x + mlp(p["mlp"], rmsnorm(p["norm2"], x, eps), cfg)
    elif kind == "dec_attn":
        x = x + attention(p["attn"], rmsnorm(p["norm1"], x, eps), cfg,
                          causal=True)
        x = x + cross_attention(p["cross"], rmsnorm(p["norm_x"], x, eps),
                                memory, cfg)
        x = x + mlp(p["mlp"], rmsnorm(p["norm2"], x, eps), cfg)
    elif kind == "ssm":
        x = x + ssm_forward(p["ssm"], rmsnorm(p["norm1"], x, eps), cfg)
    elif kind == "rwkv":
        x = x + time_mix_forward(p["tm"], rmsnorm(p["norm1"], x, eps), cfg)
        x = x + channel_mix_forward(p["cm"], rmsnorm(p["norm2"], x, eps),
                                    cfg)
    else:
        raise ValueError(kind)
    return x, aux


def _apply_block(kinds, layers, shared, x, aux, cfg, memory):
    """One repeat of a stage's pattern: the layers of ``kinds`` in turn,
    their aux losses added to ``aux``."""
    for kind, p in zip(kinds, layers):
        x, a = _apply_layer(kind, shared if kind == "shared_attn" else p, x,
                            cfg, memory)
        aux = aux + a
    return logical(x, "batch", None, None), aux


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``, the
    reference's ``dots_with_no_batch_dims_saveable``: keep the outputs of
    products without a batch axis (``mm``, ``addmm``: the projections),
    recompute the rest (``bmm``: attention scores, experts)."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    dots = (aten.mm.default, aten.addmm.default)
    return (CheckpointPolicy.MUST_SAVE if op in dots
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(save_dots: bool, fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``): its activations are recomputed in the backward;
    ``save_dots`` keeps the unbatched matmul outputs
    (``remat_policy="dots"``)."""
    from torch.utils import checkpoint as ckpt
    context_fn = ckpt.noop_context_fn
    if save_dots:
        context_fn = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return ckpt.checkpoint(fn, *args, use_reentrant=False,
                           context_fn=context_fn)


def _taking_grads(cfg: ModelConfig, x, tree) -> bool:
    """Whether a block is rematerialised: ``cfg.remat`` is set and a
    gradient flows through it (``x`` or one of its leaves needs one)."""
    return cfg.remat and torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in tree_leaves(tree)
                               if isinstance(t, torch.Tensor)))


def _run_stage(kinds, reps, layers, shared, x, cfg, memory):
    """A stage of the plan: ``reps`` repeats of ``kinds`` over ``layers``
    (``reps * len(kinds)`` entries), each repeat rematerialised while
    gradients are taken.  Returns (x, the stage's aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    k = len(kinds)
    for r in range(reps):
        block = layers[r * k:(r + 1) * k]
        args = (kinds, block, shared, x, aux, cfg, memory)
        if _taking_grads(cfg, x, (block, shared)):
            x, aux = _remat(cfg.remat_policy == "dots", _apply_block,
                            *args)
        else:
            x, aux = _apply_block(*args)
    return x, aux


def forward_hidden(params, tokens, cfg: ModelConfig, memory=None):
    """tokens (B,S) -> hidden (B,S,d) after the final norm, and the summed
    MoE aux loss (0 for the other families).  ``memory`` (B,M,d): the image
    embeddings (vlm) or the encoder output (audio, where it is required)."""
    x = embed(params["embed"], tokens, cfg)
    if cfg.family == "audio" and memory is None:
        raise ValueError("audio model needs encoder memory")
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    start = 0
    for kinds, reps in stage_plan(cfg):
        n = reps * len(kinds)
        x, aux = _run_stage(kinds, reps, params["layers"][start:start + n],
                            params.get("shared"), x, cfg, memory)
        aux_total = aux_total + aux
        start += n
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, aux_total


def encode_frames(params, frames, cfg: ModelConfig):
    """The whisper encoder over stubbed frame embeddings (B,F,d)."""
    x = frames.to(cfg.dtype)
    layers = params["encoder"]["layers"]
    x, _ = _run_stage(("enc_attn",), len(layers), layers, None, x, cfg,
                      None)
    return rmsnorm(params["encoder"]["norm"], x, cfg.norm_eps)


def _chunk_loss(embed_params, x, labels, cfg: ModelConfig):
    """Summed next-token NLL of one chunk and its count of valid labels
    (labels < 0 are masked), from float32 logits."""
    logits = unembed(embed_params, x, cfg)  # (B, C, V) float32
    lse = torch.logsumexp(logits, dim=-1)
    # the gathered (B, C, 1) meets lse at its own shape: a vocab-sharded
    # gather's pending reduction (a DTensor under the dry run) is taken
    # there, where its mask has the same shape
    gold = torch.gather(logits, -1, torch.clamp(labels, min=0)[..., None])
    valid = (labels >= 0).float()
    return torch.sum((lse[..., None] - gold)[..., 0] * valid), \
        torch.sum(valid)


def lm_loss(params, batch, cfg: ModelConfig):
    """Next-token cross-entropy (float32 scalar), chunked over
    :data:`LOSS_CHUNK` positions so the (S, V) logits never exist at once
    (vocab up to 262k); each chunk is rematerialised under ``cfg.remat``.
    ``batch``: ``tokens`` and ``labels`` (B, S) int64 tensors (labels -1
    are masked), ``memory`` (vlm) or ``frames`` (audio, run through
    :func:`encode_frames`).  A MoE adds ``0.01 *`` its aux loss, as the
    reference does (``repro/models/lm.py:229-266``)."""
    memory = batch.get("memory")
    if cfg.family == "audio":
        memory = encode_frames(params, batch["frames"], cfg)
    x, aux = forward_hidden(params, batch["tokens"], cfg, memory)
    labels = batch["labels"]
    S = x.shape[1]
    C = min(LOSS_CHUNK, S)
    pad = (-S) % C
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(x.shape[1] // C):
        args = (params["embed"], x[:, c * C:(c + 1) * C],
                labels[:, c * C:(c + 1) * C], cfg)
        if _taking_grads(cfg, x, params["embed"]):
            nll, n = _remat(False, _chunk_loss, *args)
        else:
            nll, n = _chunk_loss(*args)
        tot, cnt = tot + nll, cnt + n
    loss = tot / torch.clamp(cnt, min=1.0)
    if cfg.num_experts:
        loss = loss + 0.01 * aux
    return loss


# ------------------------------------------------------------------ serving


class DecodeCache(NamedTuple):
    layers: Tuple[Any, ...]  # one cache a layer: KVCache, SSMCache,
    #                          RwkvCache or {"self", "cross"} (dec_attn)
    memory: Optional[torch.Tensor] = None  # (B, memory_len, d) zeros
    length: int = 0          # tokens decoded: the next token's position


def _init_layer_cache(kind, cfg, batch, max_seq, memory_len, dev):
    if kind in ("attn", "attn_local", "attn_global", "moe_attn",
                "shared_attn"):
        return init_kv_cache(cfg, batch, max_seq, _kind_window(kind, cfg),
                             device=dev)
    if kind == "cross":
        return init_kv_cache(cfg, batch, memory_len, device=dev)
    if kind == "dec_attn":
        return {"self": init_kv_cache(cfg, batch, max_seq, device=dev),
                "cross": init_kv_cache(cfg, batch, memory_len, device=dev)}
    if kind == "ssm":
        return init_ssm_cache(cfg, batch, device=dev)
    if kind == "rwkv":
        return init_rwkv_cache(cfg, batch, device=dev)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               memory_len: int = 0, device=None) -> DecodeCache:
    """Zeroed caches a layer; cross caches (and ``memory``) of
    ``memory_len`` positions."""
    dev = resolve_device(device)
    layers = tuple(_init_layer_cache(kind, cfg, batch, max_seq, memory_len,
                                     dev) for kind in layer_kinds(cfg))
    mem = None
    if memory_len:
        mem = torch.zeros((batch, memory_len, cfg.d_model), dtype=cfg.dtype,
                          device=dev)
    return DecodeCache(layers, mem, 0)


def _cross_decode(p, x, kv: KVCache, cfg):
    """Decode-time cross attention against the memory K/V: no mask."""
    B = x.shape[0]
    h, hd = cfg.num_heads, cfg.hd
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, 1, h, hd)
    kk = _repeat_kv(kv.k.to(dt), h)
    vv = _repeat_kv(kv.v.to(dt), h)
    s = torch.einsum("bohd,bthd->bhot", q.float(), kk.float())
    s = s / float(np.sqrt(np.float32(hd)))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhot,bthd->bohd", w, vv.float())
    return o.reshape(B, 1, h * hd).to(dt) @ p["wo"].to(dt)


def decode_step(params, cache: DecodeCache, tokens, cfg: ModelConfig, *,
                backend: str = "cuda"):
    """tokens (B,1) -> (logits (B,1,V) float32, cache).  Attention caches
    are updated in place (see ``models.attention``), recurrent states are
    replaced; the returned :class:`DecodeCache` carries them and
    ``length + 1``.  ``backend="torch"`` takes the plain attention core
    instead of K4, to compare the two.

    The step's position is ``cache.length``, which every self-attention
    cache's length equals (cross caches are never advanced, as in the
    reference).  Its RoPE angles are built once a step, and its ring mask
    once for each distinct (cache length, window)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    x = embed(params["embed"], tokens, cfg)
    B, pos = x.shape[0], cache.length
    eps = cfg.norm_eps
    angles, masks = None, {}

    def attend(p, h, c, window):
        nonlocal angles
        if c.length != pos:
            raise ValueError(f"a self-attention cache at {c.length}, the "
                             f"step at {pos}")
        if angles is None:
            angles = rope_angles(torch.full((1,), pos, dtype=torch.int32,
                                            device=x.device),
                                 cfg.hd, cfg.rope_theta)
        C = c.k.shape[1]
        if (C, window) not in masks:
            masks[C, window] = ring_valid(pos, C, window,
                                          x.device).expand(B, C)
        return decode_attention(p, h, c, cfg, window=window, backend=backend,
                                valid=masks[C, window], angles=angles)

    new = []
    for kind, p, c in zip(layer_kinds(cfg), params["layers"], cache.layers):
        p = _layer_params(params, kind, p)
        if kind in ("attn", "attn_local", "attn_global", "moe_attn",
                    "shared_attn"):
            y, c = attend(p["attn"], rmsnorm(p["norm1"], x, eps), c,
                          _kind_window(kind, cfg))
            x = x + y
            if kind == "moe_attn":
                y, _ = moe_ffn(p["moe"], rmsnorm(p["norm2"], x, eps), cfg,
                               aux_loss=False)
                x = x + y
            else:
                x = x + mlp(p["mlp"], rmsnorm(p["norm2"], x, eps), cfg)
        elif kind == "cross":
            x = x + _cross_decode(p["cross"], rmsnorm(p["norm1"], x, eps), c,
                                  cfg)
            x = x + mlp(p["mlp"], rmsnorm(p["norm2"], x, eps), cfg)
        elif kind == "dec_attn":
            y, self_c = attend(p["attn"], rmsnorm(p["norm1"], x, eps),
                               c["self"], None)
            x = x + y
            x = x + _cross_decode(p["cross"], rmsnorm(p["norm_x"], x, eps),
                                  c["cross"], cfg)
            x = x + mlp(p["mlp"], rmsnorm(p["norm2"], x, eps), cfg)
            c = {"self": self_c, "cross": c["cross"]}
        elif kind == "ssm":
            y, c = ssm_decode(p["ssm"], rmsnorm(p["norm1"], x, eps), c, cfg)
            x = x + y
        elif kind == "rwkv":
            y, c = time_mix_decode(p["tm"], rmsnorm(p["norm1"], x, eps), c,
                                   cfg)
            x = x + y
            y, c = channel_mix_decode(p["cm"], rmsnorm(p["norm2"], x, eps),
                                      c, cfg)
            x = x + y
        else:
            raise ValueError(kind)
        new.append(c)
    x = rmsnorm(params["final_norm"], x, eps)
    return unembed(params["embed"], x, cfg), DecodeCache(
        tuple(new), cache.memory, pos + 1)
