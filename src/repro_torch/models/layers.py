"""Primitive layers of the LM serve path: RMSNorm, MLP, embeddings.

The counterpart of ``repro/models/layers.py``.  Parameters are plain dicts
of tensors in the reference's layouts ((d_in, d_out) weights, ``x @ w``).
The norm scales and the embedding table stay in ``cfg.param_dtype``
(float32): ``unembed`` multiplies in float32 against the float32 table.
The MLP weights are held in ``cfg.dtype`` (cast once at load): the
reference casts them to the compute dtype before every product, so the
products see the same values, and a decode step reads half the bytes.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F

from .common import ModelConfig, dense_init, logical, replicated, \
    unstacked

__all__ = ["init_rmsnorm", "rmsnorm", "init_mlp", "mlp", "init_embed",
           "embed", "full_float32", "unembed"]


def init_rmsnorm(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps: float = 1e-5):
    """RMSNorm with its arithmetic in float32, cast back to ``x.dtype``."""
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def init_mlp(cfg: ModelConfig, generator=None, device=None,
             d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    kw = dict(dtype=cfg.dtype, generator=generator, device=device)
    p = {}
    if cfg.act == "swiglu":
        p["gate"] = dense_init((d, f), 0, **kw)
    p["up"] = dense_init((d, f), 0, **kw)
    p["down"] = dense_init((f, d), 0, **kw)
    return p


def mlp(p, x, cfg: ModelConfig):
    dt = x.dtype
    up = x @ p["up"].to(dt)
    if cfg.act == "swiglu":
        h = F.silu(x @ p["gate"].to(dt)) * up
    else:
        h = F.gelu(up, approximate="tanh")  # jax.nn.gelu's default
    h = logical(h, "batch", None, "ff")
    return h @ p["down"].to(dt)


def init_embed(cfg: ModelConfig, generator=None, device=None):
    kw = dict(dtype=cfg.param_dtype, generator=generator, device=device)
    p = {"table": dense_init((cfg.vocab_size, cfg.d_model), 1, **kw)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init((cfg.d_model, cfg.vocab_size), 0, **kw)
    return p


def embed(p, tokens, cfg: ModelConfig):
    table = p["table"]
    if hasattr(table, "placements"):
        # a DTensor (the dry run): the table whole and ``F.embedding``,
        # whose gradient has a sharding rule where indexing's
        # ``index_put`` has none in some torch releases; token ids are
        # in range there (indexing also wraps negative ones)
        x = F.embedding(unstacked(tokens), replicated(table))
    else:
        x = table[tokens]
    return logical(x.to(cfg.dtype), "batch", None, None)


@contextmanager
def full_float32():
    """Float32 products in full float32 (no TF32) inside the block, the
    caller's setting restored after it."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def unembed(p, x, cfg: ModelConfig):
    """Float32 logits against the float32 table (or untied unembedding),
    in full float32 on the card whatever the caller's TF32 setting."""
    w = p["table"].T if cfg.tie_embeddings else p["unembed"]
    with full_float32():
        logits = x.float() @ w.float()
    return logical(logits, "batch", None, "vocab")
