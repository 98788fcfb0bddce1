"""Mixture-of-Experts FFN with top-k routing and capacity-bounded scatter
dispatch (GShard style, per batch row).

The counterpart of ``repro/models/moe.py``: the same capacity
``C = max(int(S*K/E*capacity_factor), 1)``, the same position-in-expert
cumsum per batch row, the same ``keep`` mask and Switch aux loss.  The
router is read and multiplied in float32 (TF32 off on the card), so a
bfloat16 model routes as the reference does; the expert weights are held
in the compute dtype, which the reference casts them to before its
einsums.  Plain PyTorch: the reference reaches no Pallas kernel here.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .common import ModelConfig, batch_local, dense_init, logical
from .layers import full_float32

__all__ = ["init_moe", "top_k", "moe_ffn"]


def init_moe(cfg: ModelConfig, generator=None, device=None):
    """The router in ``cfg.param_dtype``, the stacked (E, d, f) / (E, f, d)
    expert weights in ``cfg.dtype``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    kw = dict(generator=generator, device=device)
    p = {"router": dense_init((d, e), 0, cfg.param_dtype, **kw)}
    if cfg.act == "swiglu":
        p["experts_gate"] = dense_init((e, d, f), 1, cfg.dtype, **kw)
    p["experts_up"] = dense_init((e, d, f), 1, cfg.dtype, **kw)
    p["experts_down"] = dense_init((e, f, d), 1, cfg.dtype, **kw)
    return p


def top_k(x, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, ties to the lower index (a stable sort; the order of
    ``torch.topk`` among equal values is unspecified)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(p, x, cfg: ModelConfig, aux_loss: bool = True
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B,S,d) -> (y (B,S,d), aux loss scalar float32).  The decode path,
    which discards the aux loss as the reference's does, passes
    ``aux_loss=False`` and gets None (the reference's jit drops the unused
    computation; eagerly it would cost a step its kernels)."""
    y, aux, _ = _moe_ffn(p, x, cfg, aux_loss)
    return y, aux


def _one_hot(idx, n: int):
    """``jax.nn.one_hot(idx, n, dtype=int32)`` as a comparison (without
    ``F.one_hot``'s range checks, which are kernels of their own on the
    card); idx holds expert ids in [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.int32)


def _rows(flat):
    """The batch row of each (token, k) copy: (B, S*K)."""
    B, T = flat.shape
    return torch.arange(B, device=flat.device)[:, None].expand(B, T)


def _dispatch(xrep, flat, keep, safe_pos, E: int, C: int, bidx=None):
    """Scatter the token copies ``xrep`` (B, S*K, d) into (B, E, C, d)
    expert buffers; a dropped copy adds zeros at C-1, as the reference's
    does.  ``bidx``: :func:`_rows` of ``flat`` (made here if None)."""
    B, _, d = xrep.shape
    buf = torch.zeros((B, E, C, d), dtype=xrep.dtype, device=xrep.device)
    bidx = _rows(flat) if bidx is None else bidx
    buf.index_put_((bidx, flat, torch.where(keep, safe_pos, C - 1)),
                   torch.where(keep[..., None], xrep, 0), accumulate=True)
    return buf


def _gather_back(out_buf, flat, safe_pos, bidx=None):
    """Each copy's expert output: (B, S*K, d)."""
    bidx = _rows(flat) if bidx is None else bidx
    return out_buf[bidx, flat, safe_pos]


def _moe_ffn(p, x, cfg: ModelConfig, aux_loss: bool = True):
    """:func:`moe_ffn` and its ``keep`` mask (B, S*K): which (token, k)
    copies found room in their expert."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    dt = x.dtype
    C = max(int(S * K / E * cfg.capacity_factor), 1)

    with full_float32():
        logits = x.float() @ p["router"].float()  # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    gates, topk = top_k(probs, K)  # (B,S,K)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)

    aux = None
    if aux_loss:  # Switch: E * sum_e(fraction of tokens) * (gate mass)
        token_frac = _one_hot(topk[..., 0], E).float().mean(dim=(0, 1))
        gate_frac = probs.mean(dim=(0, 1))
        aux = E * torch.sum(token_frac * gate_frac)

    # position of each (token, k) inside its expert, per batch row
    flat = topk.reshape(B, S * K)  # expert ids
    oh = _one_hot(flat, E)  # (B, S*K, E)
    pos = torch.cumsum(oh, dim=1) - 1
    pos_in_e = (pos * oh).sum(dim=-1)  # (B, S*K)
    keep = pos_in_e < C

    # scatter the token copies into (B, E, C, d) buffers; a dropped copy
    # adds zeros at C-1, as the reference's does
    xrep = x.repeat_interleave(K, dim=1)  # (B, S*K, d)
    bidx = None if hasattr(x, "placements") else _rows(flat)
    safe_pos = torch.where(keep, pos_in_e, 0)
    buf = batch_local(functools.partial(_dispatch, E=E, C=C, bidx=bidx),
                      xrep, flat, keep, safe_pos)
    buf = logical(buf, "batch", "experts", None, None)

    # under a mesh the expert weights are gathered over their FSDP dim d
    # before the products (the sharding policy's FSDP), expert and FFN
    # dims on the rules' axes
    w_in = ("experts", None, "moe_ff")
    up = torch.einsum("becd,edf->becf", buf,
                      logical(p["experts_up"].to(dt), *w_in))
    if cfg.act == "swiglu":
        g = torch.einsum("becd,edf->becf", buf,
                         logical(p["experts_gate"].to(dt), *w_in))
        h = F.silu(g) * up
    else:
        h = F.gelu(up, approximate="tanh")  # jax.nn.gelu's default
    # "moe_ff" maps to the model axis only when experts don't (EP vs TP)
    h = logical(h, "batch", "experts", None, "moe_ff")
    out_buf = torch.einsum("becf,efd->becd", h, logical(
        p["experts_down"].to(dt), "experts", "moe_ff", None))

    # gather back and combine with the gates
    y_tok = batch_local(functools.partial(_gather_back, bidx=bidx), out_buf,
                        flat, safe_pos)  # (B, S*K, d)
    y_tok = torch.where(keep[..., None], y_tok, 0)
    y_tok = y_tok * gates.reshape(B, S * K)[..., None].to(dt)
    y = y_tok.reshape(B, S, K, d).sum(dim=2)
    return logical(y, "batch", None, None), aux, keep
