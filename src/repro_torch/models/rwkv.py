"""RWKV6 ("Finch") time-mix and channel-mix: attention-free, with a
data-dependent per-channel decay.

The counterpart of ``repro/models/rwkv.py``.  The forward (prefill) is the
reference's exact log-space chunked form: within a chunk of Q tokens the
pairwise decay products are taken in log space over a (Q, Q, hd)
broadcast (only s < t terms, whose log decays are <= 0), and across chunks
a loop carries each head's (hd x hd) wkv state with factors
``exp(LW_end - LW_s) <= 1``.  Decode is the O(1) recurrence.  ``w0``, ``u``
and the ``ln_out`` scale are read in float32, as the reference reads them;
the projections are held in the compute dtype.  Plain PyTorch: the
reference reaches no Pallas kernel here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import ModelConfig, dense_init, logical
from .layers import init_rmsnorm, rmsnorm

__all__ = ["init_time_mix", "init_channel_mix", "RwkvCache",
           "init_rwkv_cache", "time_mix_forward", "time_mix_decode",
           "channel_mix_forward", "channel_mix_decode"]

_LORA_RANK = 64


def _dims(cfg: ModelConfig):
    d = cfg.d_model
    hd = cfg.ssm_head_dim or 64
    H = d // hd
    return d, H, hd


def init_time_mix(cfg: ModelConfig, generator=None, device=None):
    d, H, hd = _dims(cfg)
    kw = dict(dtype=cfg.dtype, generator=generator, device=device)
    return {
        "wr": dense_init((d, d), 0, **kw),
        "wk": dense_init((d, d), 0, **kw),
        "wv": dense_init((d, d), 0, **kw),
        "wg": dense_init((d, d), 0, **kw),
        "wo": dense_init((d, d), 0, **kw),
        "w_lora_a": dense_init((d, _LORA_RANK), 0, **kw),
        "w_lora_b": dense_init((_LORA_RANK, d), 0, **kw),
        # r, k, v, w, g shift mix (cast to the compute dtype at each use)
        "mu": torch.full((5, d), 0.5, dtype=cfg.dtype, device=device),
        # base log-log decay and bonus, read in float32
        "w0": torch.full((d,), -0.6, dtype=cfg.param_dtype, device=device),
        "u": torch.zeros((H, hd), dtype=cfg.param_dtype, device=device),
        "ln_out": init_rmsnorm(d, cfg.param_dtype, device),
    }


def init_channel_mix(cfg: ModelConfig, generator=None, device=None):
    d = cfg.d_model
    kw = dict(dtype=cfg.dtype, generator=generator, device=device)
    return {
        "wk": dense_init((d, cfg.d_ff), 0, **kw),
        "wv": dense_init((cfg.d_ff, d), 0, **kw),
        "wr": dense_init((d, d), 0, **kw),
        "mu": torch.full((2, d), 0.5, dtype=cfg.dtype, device=device),
    }


def _shift(x, last=None):
    """Token shift: x_{t-1} (zeros, or ``last`` (B, d), at t=0). x (B,S,d)."""
    prev = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([prev, x[:, :-1]], dim=1)


def _mix(x, xprev, mu):
    return x + (xprev - x) * mu.to(x.dtype)


def _projections(p, x, xprev, cfg: ModelConfig):
    d, H, hd = _dims(cfg)
    B, S, _ = x.shape
    dt = x.dtype
    mu = p["mu"]
    r = _mix(x, xprev, mu[0]) @ p["wr"].to(dt)
    k = _mix(x, xprev, mu[1]) @ p["wk"].to(dt)
    v = _mix(x, xprev, mu[2]) @ p["wv"].to(dt)
    xw = _mix(x, xprev, mu[3])
    g = _mix(x, xprev, mu[4]) @ p["wg"].to(dt)
    wl = torch.tanh(xw @ p["w_lora_a"].to(dt)) @ p["w_lora_b"].to(dt)
    # (B,S,d) <= 0: the per-channel log decay
    logw = -torch.exp(torch.clamp(p["w0"].float() + wl.float(), -8.0, 4.0))
    shape = (B, S, H, hd)
    return (r.reshape(shape), k.reshape(shape), v.reshape(shape),
            logw.reshape(shape), g)


class RwkvCache(NamedTuple):
    state: torch.Tensor    # (B, H, hd, hd) wkv state (k-dim x v-dim), f32
    last_tm: torch.Tensor  # (B, d) last input of time-mix
    last_cm: torch.Tensor  # (B, d) last input of channel-mix
    length: int


def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype=None,
                    device=None) -> RwkvCache:
    d, H, hd = _dims(cfg)
    dt = dtype or cfg.dtype
    return RwkvCache(
        torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
        torch.zeros((batch, d), dtype=dt, device=device),
        torch.zeros((batch, d), dtype=dt, device=device),
        0)


def time_mix_forward(p, x, cfg: ModelConfig):
    """x (B,S,d) -> (B,S,d): the chunked scan over the wkv state."""
    d, H, hd = _dims(cfg)
    B, S, _ = x.shape
    dt_c = x.dtype
    r, k, v, lw, g = _projections(p, x, _shift(x), cfg)
    u = p["u"].float()

    Q = min(cfg.rwkv_chunk, S)
    pad = (-S) % Q
    if pad:
        r, k, v, lw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, lw))
    nc = r.shape[1] // Q
    # the chunk loop walks the sequence: each shard holds all of it
    r, k, v, lw = (logical(t, "batch", None, "heads", None)
                   for t in (r, k, v, lw))

    def to_chunks(t):  # (B, nc*Q, H, hd) -> (nc, B, H, Q, hd)
        return t.reshape(B, nc, Q, H, hd).permute(1, 0, 3, 2, 4).float()

    rc, kc, vc, lwc = map(to_chunks, (r, k, v, lw))
    strict = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device), diagonal=-1)
    # zeros laid out as the chunks (a DTensor's placements too: see
    # attention._accumulators)
    state = torch.zeros_like(rc[0][:, :, :1]).expand(B, H, hd, hd)
    ys = []
    for rq, kq, vq, lwq in zip(rc, kc, vc, lwc):  # each (B,H,Q,hd)
        cum = torch.cumsum(lwq, dim=2)   # LW_t inclusive
        cum_in = cum - lwq               # LW_{t-1}
        # inter: y_t = (r_t . exp(cum_in_t)) @ state
        y = torch.einsum("bhqc,bhcv->bhqv", rq * torch.exp(cum_in), state)
        # intra (exact, s<t): A[t,s] = sum_c r_tc k_sc exp(cum_in_t - cum_s)
        dec = torch.exp(cum_in[:, :, :, None, :] - cum[:, :, None, :, :])
        dec = torch.where(strict[None, None, :, :, None], dec, 0.0)
        a = (rq[:, :, :, None, :] * kq[:, :, None, :, :] * dec).sum(dim=-1)
        y = y + torch.einsum("bhts,bhsv->bhtv", a, vq)
        # bonus diagonal: r_t . diag(u) k_t v_t
        diag = torch.sum(rq * u[None, :, None, :] * kq, dim=-1)  # (B,H,Q)
        y = y + diag[..., None] * vq
        # S' = diag(exp(LW_end)) S + sum_s exp(LW_end - LW_s) k_s v_s
        tot = cum[:, :, -1:, :]                     # (B,H,1,hd)
        kd = kq * torch.exp(tot - cum)              # factors <= 1
        state = state * torch.exp(tot[:, :, 0, :])[..., None] \
            + torch.einsum("bhsc,bhsv->bhcv", kd, vq)
        ys.append(y)
    # (nc, B, H, Q, hd) -> (B, nc, Q, H, hd) -> (B, S, d)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(
        B, nc * Q, H * hd)[:, :S]
    y = rmsnorm(p["ln_out"], y.to(dt_c), cfg.norm_eps)
    y = y * F.silu(g)
    return y @ p["wo"].to(dt_c)


def time_mix_decode(p, x, cache: RwkvCache, cfg: ModelConfig):
    """x (B,1,d) -> (out (B,1,d), cache): the one-token recurrence."""
    d, H, hd = _dims(cfg)
    B = x.shape[0]
    dt_c = x.dtype
    r, k, v, lw, g = _projections(p, x, cache.last_tm[:, None, :].to(dt_c),
                                  cfg)
    rq, kq, vq = (t[:, 0].float() for t in (r, k, v))  # (B,H,hd)
    lwq = lw[:, 0].float()
    u = p["u"].float()
    # y = r . (state + diag(u) k^T v)
    y = torch.einsum("bhc,bhcv->bhv", rq, cache.state)
    y = y + torch.sum(rq * u[None] * kq, dim=-1)[..., None] * vq
    state = cache.state * torch.exp(lwq)[..., None] \
        + kq[..., None] * vq[:, :, None, :]
    y = y.reshape(B, 1, d).to(dt_c)
    y = rmsnorm(p["ln_out"], y, cfg.norm_eps) * F.silu(g)
    out = y @ p["wo"].to(dt_c)
    return out, RwkvCache(state, x[:, 0], cache.last_cm, cache.length + 1)


def channel_mix_forward(p, x, cfg: ModelConfig, last=None):
    dt = x.dtype
    xprev = _shift(x, last)
    mu = p["mu"]
    k = _mix(x, xprev, mu[0]) @ p["wk"].to(dt)
    r = _mix(x, xprev, mu[1]) @ p["wr"].to(dt)
    h = torch.square(torch.relu(k))
    h = logical(h, "batch", None, "ff")
    return torch.sigmoid(r) * (h @ p["wv"].to(dt))


def channel_mix_decode(p, x, cache: RwkvCache, cfg: ModelConfig):
    out = channel_mix_forward(p, x, cfg, last=cache.last_cm.to(x.dtype))
    return out, cache._replace(last_cm=x[:, 0])
