"""Mamba2 (SSD) layer: the chunked matmul-form state-space scan.

The counterpart of ``repro/models/ssm.py``.  The forward (prefill) is the
state-space-duality chunked algorithm: within a chunk of Q tokens, dense
products with an exact (Q, Q) decay matrix per head (the per-head decay is
a scalar); across chunks a loop carries the (H, N, P) state.  Decode is
the O(1) recurrence on the same state plus a depthwise-conv ring window,
kept in ``cfg.dtype`` and summed in float32.  ``A_log``, ``D``,
``dt_bias``, ``conv_w`` and the norm scale are held in
``cfg.param_dtype``: the reference reads them in float32 (``conv_w`` and
``D`` in the compute dtype in the forward).  Plain PyTorch: the reference
reaches no Pallas kernel here.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .common import ModelConfig, dense_init, logical
from .layers import init_rmsnorm, rmsnorm

__all__ = ["init_ssm", "SSMCache", "init_ssm_cache", "ssm_forward",
           "ssm_decode"]


def _dims(cfg: ModelConfig):
    di = cfg.d_inner
    H = cfg.ssm_heads
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_ch = di + 2 * N
    return di, H, P, N, conv_ch


def init_ssm(cfg: ModelConfig, generator=None, device=None):
    di, H, P, N, conv_ch = _dims(cfg)
    d = cfg.d_model
    kw = dict(generator=generator, device=device)
    f32 = dict(dtype=cfg.param_dtype, device=device)
    return {
        "in_proj": dense_init((d, 2 * di + 2 * N + H), 0, cfg.dtype, **kw),
        "out_proj": dense_init((di, d), 0, cfg.dtype, **kw),
        "conv_w": dense_init((cfg.ssm_conv, conv_ch), 0, cfg.param_dtype,
                             **kw),
        "A_log": torch.zeros((H,), **f32),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm": init_rmsnorm(di, cfg.param_dtype, device),
    }


def _split_proj(p, u, cfg: ModelConfig):
    di, H, P, N, conv_ch = _dims(cfg)
    zxbcdt = u @ p["in_proj"].to(u.dtype)
    z, xbc, dt = torch.split(zxbcdt, [di, conv_ch, H], dim=-1)
    return z, xbc, dt


def _conv_train(p, xbc, cfg: ModelConfig):
    """Causal depthwise conv over (B,S,ch), then SiLU."""
    kw = cfg.ssm_conv
    w = p["conv_w"].to(xbc.dtype)  # (kw, ch)
    # zeros before the sequence (a cat: some DTensor releases fail on pad)
    pad = torch.cat([xbc.new_zeros((xbc.shape[0], kw - 1, xbc.shape[2])),
                     xbc], dim=1)
    S = xbc.shape[1]
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(kw))
    return F.silu(out)


class SSMCache(NamedTuple):
    state: torch.Tensor  # (B, H, N, P) float32
    conv: torch.Tensor   # (B, kw-1, conv_ch) cfg.dtype
    length: int


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=None,
                   device=None) -> SSMCache:
    di, H, P, N, conv_ch = _dims(cfg)
    dt = dtype or cfg.dtype
    return SSMCache(
        torch.zeros((batch, H, N, P), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dt,
                    device=device),
        0)


def ssm_forward(p, u, cfg: ModelConfig):
    """u (B,S,d_model) -> (B,S,d_model): the chunked SSD scan."""
    di, H, P, N, _ = _dims(cfg)
    B, S, _ = u.shape
    dt_c = u.dtype
    z, xbc, dt_raw = _split_proj(p, u, cfg)
    xbc = _conv_train(p, xbc, cfg)
    x, Bm, Cm = torch.split(xbc, [di, N, N], dim=-1)
    x = x.reshape(B, S, H, P)
    x = logical(x, "batch", None, "heads", None)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())  # (B,S,H)
    A = -torch.exp(p["A_log"].float())  # (H,) negative
    a = dt * A  # (B,S,H) per-step log decay

    Q = min(cfg.ssm_chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        Bm, Cm, dt, a = (F.pad(t, (0, 0, 0, pad)) for t in (Bm, Cm, dt, a))
    nc = x.shape[1] // Q
    # the chunk loop walks the sequence: each shard holds all of it
    Bm, Cm = (logical(t, "batch", None, None) for t in (Bm, Cm))
    dt, a = (logical(t, "batch", None, "heads") for t in (dt, a))

    def to_chunks(t):  # (B, nc*Q, ...) -> (nc, B, Q, ...)
        return t.reshape((B, nc, Q) + t.shape[2:]).transpose(0, 1)

    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=u.device))
    # zeros laid out as x (a DTensor's placements too: see
    # attention._accumulators)
    state = torch.zeros_like(x[:, :1], dtype=torch.float32).transpose(
        1, 2).expand(B, H, N, P)
    ys = []
    for xq, bq, cq, dtq, aq in zip(*map(to_chunks, (x, Bm, Cm, dt, a))):
        cum = torch.cumsum(aq, dim=1)  # (B,Q,H)
        # intra-chunk: y[t] = sum_{s<=t} exp(cum_t-cum_s) (C_t.B_s) dt_s x_s
        scores = torch.einsum("btn,bsn->bts", cq.float(), bq.float())
        decay = cum[:, :, None, :] - cum[:, None, :, :]  # (B,t,s,H)
        L = torch.where(causal[None, :, :, None], torch.exp(decay), 0.0)
        w_ts = scores[..., None] * L  # (B,t,s,H)
        dx = dtq[..., None] * xq.float()  # (B,Q,H,P)
        y = torch.einsum("btsh,bshp->bthp", w_ts, dx)
        # inter-chunk: y[t] += exp(cum_t) C_t . state
        y = y + torch.einsum("btn,bhnp->bthp", cq.float(), state) \
            * torch.exp(cum)[..., None]
        # state update
        tot = cum[:, -1:, :]  # (B,1,H)
        sdecay = torch.exp(tot - cum)  # (B,Q,H) decay from s to chunk end
        state = state * torch.exp(tot[:, 0, :])[:, :, None, None] \
            + torch.einsum("bsh,bsn,bshp->bhnp", sdecay, bq.float(), dx)
        ys.append(y.to(dt_c))
    y = torch.stack(ys, dim=1).reshape(B, nc * Q, H, P)[:, :S]
    y = y + x[:, :S] * p["D"].to(dt_c)[None, None, :, None]
    y = y.reshape(B, S, di)
    y = rmsnorm(p["norm"], y, cfg.norm_eps) * F.silu(z)
    return y @ p["out_proj"].to(dt_c)


def ssm_decode(p, u, cache: SSMCache,
               cfg: ModelConfig) -> Tuple[torch.Tensor, SSMCache]:
    """One-token decode: u (B,1,d_model) -> (B,1,d_model) and the cache."""
    di, H, P, N, conv_ch = _dims(cfg)
    B = u.shape[0]
    dt_c = u.dtype
    z, xbc, dt_raw = _split_proj(p, u, cfg)
    # conv ring: window = [cache (kw-1), new]
    win = torch.cat([cache.conv, xbc.to(cache.conv.dtype)], dim=1)
    w = p["conv_w"].float()  # (kw, ch)
    conv_out = torch.sum(win.float() * w[None], dim=1)  # (B,ch)
    xbc1 = F.silu(conv_out).to(dt_c)
    x, Bm, Cm = torch.split(xbc1, [di, N, N], dim=-1)
    x = x.reshape(B, H, P)
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"].float())  # (B,H)
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt * A)  # (B,H)
    inc = torch.einsum("bh,bn,bhp->bhnp", dt, Bm.float(), x.float())
    state = cache.state * decay[..., None, None] + inc
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), state)
    y = y + x.float() * p["D"].float()[None, :, None]
    y = y.reshape(B, 1, di).to(dt_c)
    y = rmsnorm(p["norm"], y, cfg.norm_eps) * F.silu(z)
    out = y @ p["out_proj"].to(dt_c)
    return out, SSMCache(state, win[:, 1:], cache.length + 1)
