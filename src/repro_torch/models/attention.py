"""Attention of the LM: RoPE, GQA, the chunked online-softmax forward
(training and prefill), and single-token decode against a ring KV cache
through K4.

The counterpart of ``repro/models/attention.py``.  :func:`decode_attention`
is the serve hot spot: its core (pre-scaled float32 query against the
cache, masked to -1e30 by ``valid``, softmax, weighted V) is the TPU
kernel ``flash_decode_pallas``'s function, and on the card it launches
the port's K4 (``repro_torch.kernels.flash_decode``) without a repeated
copy of the cache.  The forward path (:func:`attention`, :func:`_flash`)
is plain PyTorch, as the reference's is plain jnp.  Sliding-window causal
self-attention whose sequence spans more chunks than its band takes
:func:`_flash_banded` (the reference's banded prefill): each q chunk
visits only the kv chunks of its band, so the work scales with
S * window instead of S * T.

Under a dry run's mesh (``launch/dryrun.py``) the operands are
``DTensor``s.  A cache sharded along its sequence (the long-context cell,
batch 1) takes :func:`_decode_sequence_sharded`: each shard attends over
its own positions and two all-reduces merge the partial softmaxes, where
the reference leaves GSPMD to derive the same distributed softmax.

Difference from the reference, by design: the cache slot of the new token
is written in place, where the reference returns a new cache from
``dynamic_update_slice``; at full width a functional update would copy
the whole 2.68 GB cache each step.  ``KVCache.length`` is a Python int
(every sequence of a batch is at the same position, as in the reference).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels.flash_decode import NEG_INF, flash_decode, flash_decode_torch
from .common import ModelConfig, dense_init, logical, shard_local

__all__ = ["rope", "rope_angles", "init_attention", "attention",
           "cross_attention", "KVCache", "init_kv_cache", "ring_valid",
           "decode_attention", "prefill_kv", "BACKENDS"]

#: ``"cuda"``: the decode core through K4 (its plain version on CPU
#: tensors); ``"torch"``: the plain version on any device.
BACKENDS = ("cuda", "torch")

# ---------------------------------------------------------------------- RoPE
def rope_angles(positions, hd: int, theta: float = 1e4):
    """(cos, sin), each (..., S, 1, hd/2) float32, of the rotation angles
    at ``positions`` (..., S), as the reference computes them."""
    half = hd // 2
    # log(theta) in float32, taken on the host: a host tensor moved to the
    # card would be a copy that waits for the stream
    log_theta = float(np.log(np.float32(theta)))
    freqs = torch.exp(-log_theta * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., :, None].float() * freqs  # (..., S, half)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x, positions, theta: float = 1e4):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    return _rotate(x, *rope_angles(positions, x.shape[-1], theta))


# -------------------------------------------------------------- param blocks
def init_attention(cfg: ModelConfig, generator=None, device=None,
                   cross: bool = False):
    """Projection weights in ``cfg.dtype`` (see ``models.layers``).  A
    cross-attention block (``cross=True``) has the same four projections,
    as in the reference."""
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    kw = dict(dtype=cfg.dtype, generator=generator, device=device)
    return {
        "wq": dense_init((d, h * hd), 0, **kw),
        "wk": dense_init((d, kvh * hd), 0, **kw),
        "wv": dense_init((d, kvh * hd), 0, **kw),
        "wo": dense_init((h * hd, d), 0, **kw),
    }


# ------------------------------------------------------- flash core (q long)
def _flash(q, k, v, q_pos, kv_pos, *, causal: bool, window: Optional[int],
           chunk: int, kv_len=None):
    """q: (B,S,H,hd), k/v: (B,T,H,hd) (kv already repeated to H heads).

    Returns (B,S,H,hd).  Sliding-window causal self-attention whose q
    spans more chunks than its band takes :func:`_flash_banded`, under the
    reference's condition (``attention.py:64-67``); everything else
    :func:`_flash_chunks`."""
    S, T = q.shape[1], k.shape[1]
    chunk = min(chunk, T)
    if (window is not None and causal and S == T and kv_len is None
            and S % chunk == 0 and S // chunk > window // chunk + 1):
        return _flash_banded(q, k, v, q_pos, window=window, chunk=chunk)
    return _flash_chunks(q, k, v, q_pos, kv_pos, causal=causal,
                         window=window, chunk=chunk, kv_len=kv_len)


def _flash_chunks(q, k, v, q_pos, kv_pos, *, causal: bool,
                  window: Optional[int], chunk: int, kv_len=None):
    """The online softmax of every q position over all kv chunks of
    ``chunk`` positions, products of compute-dtype operands accumulated in
    float32 (the reference's ``preferred_element_type``).  Masks: causal,
    sliding window, ``kv_len`` for padded caches."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    chunk = min(chunk, T)
    pad = (-T) % chunk
    if pad:  # zeros after the sequence (a cat: some DTensor releases
        # fail on pad)
        k, v = (torch.cat([t, t.new_zeros((B, pad) + tuple(t.shape[2:]))],
                          dim=1) for t in (k, v))
        kv_pos = torch.nn.functional.pad(
            kv_pos, (0, pad), value=np.iinfo(np.int32).max // 2)
    nchunk = k.shape[1] // chunk
    qs = _scaled(q)

    o, m, l = _accumulators(qs.transpose(1, 2))  # (B,H,S,hd), (B,H,S) x 2
    for j in range(nchunk):
        sl = slice(j * chunk, (j + 1) * chunk)
        kb, vb, pb = k[:, sl], v[:, sl], kv_pos[sl]
        s = torch.einsum("bshd,bthd->bhst", qs, kb.float())
        mask = torch.ones((S, chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= pb[None, :]
        if window is not None:
            mask &= (q_pos[:, None] - pb[None, :]) < window
        if kv_len is not None:
            mask &= pb[None, :] < kv_len
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhst,bthd->bhsd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    o = o / torch.clamp(l, min=1e-30)[..., None]
    return o.transpose(1, 2).to(q.dtype)  # (B,S,H,hd)


def _accumulators(like):
    """The online softmax's running output (zeros of ``like``'s shape),
    row max (-1e30) and row sum (zeros, without ``like``'s last dim), in
    float32, contiguous, laid out as ``like`` (a ``DTensor``'s placements
    too: under a mesh, zeros made apart from the operands would enter as
    replicated and ask a partial gradient of a sharded one)."""
    kw = dict(dtype=torch.float32, memory_format=torch.contiguous_format)
    o = torch.zeros_like(like, **kw)
    return (o, torch.full_like(like[..., 0], NEG_INF, **kw),
            torch.zeros_like(like[..., 0], **kw))


def _scaled(q):
    """``q * 1/sqrt(hd)`` in q's dtype (the scale rounded to it, as the
    reference's), as float32 operands."""
    scale = float(torch.tensor(1.0 / np.sqrt(q.shape[-1]), dtype=q.dtype))
    return (q * scale).float()


def _flash_banded(q, k, v, q_pos, *, window: int, chunk: int):
    """Sliding-window causal self-attention over q chunks: q chunk ``qi``
    visits kv chunks ``qi, qi-1, ..., qi-band+1`` in that order (band =
    ``window // chunk + 1``), as the reference's ``_flash_banded``
    (``attention.py:116-158``) does; a chunk index below 0 visits chunk 0
    wholly masked.  The q chunks go side by side, so the band's ``band``
    steps each cover every chunk; the order of the online-softmax
    accumulation within a q chunk is the reference's."""
    B, S, H, hd = q.shape
    nq = S // chunk
    band = window // chunk + 1
    qc = _scaled(q).reshape(B, nq, chunk, H, hd)
    kc = k.reshape(B, nq, chunk, H, hd)
    vc = v.reshape(B, nq, chunk, H, hd)
    pc = q_pos.reshape(nq, chunk)
    qi = torch.arange(nq, device=q.device)
    o, m, l = _accumulators(qc.transpose(2, 3))  # (B,nq,H,chunk,hd), ...
    for b in range(band):
        j = torch.clamp(qi - b, min=0)
        kb, vb, pb = kc.index_select(1, j), vc.index_select(1, j), pc[j]
        s = torch.einsum("bnshd,bnthd->bnhst", qc, kb.float())
        d = pc[:, :, None] - pb[:, None, :]  # (nq, chunk, chunk)
        mask = (d >= 0) & (d < window) & (qi - b >= 0)[:, None, None]
        s = torch.where(mask[None, :, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "bnhst,bnthd->bnhsd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    o = o / torch.clamp(l, min=1e-30)[..., None]
    # (B, nq, H, chunk, hd) -> (B, S, H, hd)
    return o.transpose(2, 3).reshape(B, S, H, hd).to(q.dtype)


def _repeat_kv(x, h: int):
    kvh = x.shape[2]
    if kvh == h:
        return x
    return torch.repeat_interleave(x, h // kvh, dim=2)


def _heads(y, n: int, hd: int, axis: str):
    """A projection's output (B, S, n*hd) as (B, S, n, hd), laid out by the
    rules' ``axis`` (``"heads"`` or ``"kv_heads"``).  The flat output is
    pinned first: where the rules do not split the heads over the model
    axis it is gathered whole, since a shard of the flat dim may end
    inside a head, which ``DTensor`` cannot view as heads."""
    B, S, _ = y.shape
    y = logical(y, "batch", None, axis).reshape(B, S, n, hd)
    return logical(y, "batch", None, axis, None)


def _merged(o):
    """The core's output (B, S, H, hd) as (B, S, H*hd) for ``wo``, pinned
    with its gradient by the core's heads or queries (a no-op going
    forward): the gradient that ``wo``'s product returns is split over
    the flat dim, which ``DTensor`` cannot view as heads where a shard
    ends inside a head."""
    B, S, h, hd = o.shape
    return logical(o.reshape(B, S, h * hd), "batch", "queries", "heads",
                   grad=True)


def _split(x, dim: int) -> bool:
    """Whether ``x`` is a ``DTensor`` split along ``dim``."""
    return any(p.is_shard(dim) for p in getattr(x, "placements", ()))


def _attend(core, q, k, v, q_pos, h: int):
    """``core(q, k, v, q_pos)`` (the attention core, (B,S,H,hd) out) with k
    and v repeated to the ``h`` query heads.  With sharding rules, each
    chip runs the core on its own share (``shard_local``): its heads, with
    k and v laid out alike, where the rules split the heads; else its
    queries (and their positions) where the rules split them (the
    ``"queries"`` axis), against k and v whole.  Without rules, or where
    neither is split, ``DTensor`` lays the core out."""
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    q = logical(q, "batch", None, "heads", None)
    if _split(q, 2):
        k, v = (logical(t, "batch", None, "heads", None) for t in (k, v))
        return shard_local(lambda q, k, v: core(q, k, v, q_pos), q, k, v)
    q = logical(q, "batch", "queries", None, None)
    if not _split(q, 1):
        return core(q, k, v, q_pos)
    k, v = (logical(t, "batch", None, None, None) for t in (k, v))
    mesh = q.device_mesh
    axis = next(i for i, p in enumerate(q.placements) if p.is_shard(1))
    mine = q_pos.chunk(mesh.size(axis))[mesh.get_coordinate()[axis]]
    from torch.distributed.tensor import Partial
    summed = [Partial() if i == axis else p
              for i, p in enumerate(k.placements)]
    return shard_local(lambda q, k, v: core(q, k, v, mine), q, k, v,
                       grad_placements=[None, summed, summed])


def attention(p, x, cfg: ModelConfig, *, causal=True, window=None,
              positions=None, use_rope=True):
    """Self-attention over x (B,S,d) for prefill (the forward path)."""
    B, S, _ = x.shape
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt = x.dtype
    q = _heads(x @ p["wq"].to(dt), h, hd, "heads")
    k = _heads(x @ p["wk"].to(dt), kvh, hd, "kv_heads")
    v = _heads(x @ p["wv"].to(dt), kvh, hd, "kv_heads")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = _attend(functools.partial(
        _flash, kv_pos=positions, causal=causal, window=window,
        chunk=cfg.attn_chunk), q, k, v, positions, h)
    return _merged(o) @ p["wo"].to(dt)


def cross_attention(p, x, memory, cfg: ModelConfig):
    """x (B,S,d) attends to memory (B,M,d): no mask, no RoPE, over the
    same chunked core.  K and V take the promoted type of ``memory`` and
    the compute dtype, as jnp's mixed products do."""
    B, S, _ = x.shape
    M = memory.shape[1]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt = x.dtype
    mt = torch.promote_types(memory.dtype, dt)
    q = _heads(x @ p["wq"].to(dt), h, hd, "heads")
    k = _heads(memory.to(mt) @ p["wk"].to(mt), kvh, hd, "kv_heads")
    v = _heads(memory.to(mt) @ p["wv"].to(mt), kvh, hd, "kv_heads")
    qp = torch.arange(S, dtype=torch.int32, device=x.device)
    kp = torch.arange(M, dtype=torch.int32, device=x.device)
    o = _attend(functools.partial(
        _flash, kv_pos=kp, causal=False, window=None,
        chunk=cfg.attn_chunk), q, k, v, qp, h)
    return _merged(o) @ p["wo"].to(dt)


# --------------------------------------------------------------- decode path
class KVCache(NamedTuple):
    k: torch.Tensor  # (B, C, kvh, hd)  C = window or max_seq
    v: torch.Tensor
    length: int      # tokens seen so far (ring for windowed)


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  window: Optional[int] = None, dtype=None,
                  device=None) -> KVCache:
    c = min(window, max_seq) if window else max_seq
    shape = (batch, c, cfg.num_kv_heads, cfg.hd)
    dt = dtype or cfg.dtype
    return KVCache(torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device), 0)


def ring_valid(pos: int, C: int, window: Optional[int] = None,
               device=None) -> torch.Tensor:
    """(C,) bool: which ring slots hold a position the token at ``pos``
    attends to, once it is written at slot ``pos % C`` (the reference's
    ``abs_pos``/``valid``, ``attention.py:248-254``)."""
    slot = pos % C
    idx = torch.arange(C, dtype=torch.int64, device=device)
    # slot i currently holds absolute position: latest write wins
    abs_pos = torch.where(idx <= slot, pos - (slot - idx),
                          pos - C + (idx - slot))
    valid = (abs_pos >= 0) & (abs_pos <= pos)
    if window is not None:
        valid &= (pos - abs_pos) < window
    return valid


def decode_attention(p, x, cache: KVCache, cfg: ModelConfig, *,
                     window: Optional[int] = None, use_rope=True,
                     backend: str = "cuda", valid=None, angles=None):
    """One-token decode: x (B,1,d) + cache -> (out (B,1,d), cache).

    The new token's K and V are written into ``cache`` in place (slot
    ``length % C``); the returned cache holds the same tensors with
    ``length + 1``.  ``backend="cuda"`` computes the attention core with K4
    (``flash_decode``), ``"torch"`` with its plain version.  ``valid``
    ((B, C) bool, :func:`ring_valid` of this position) and ``angles``
    (:func:`rope_angles` of it) depend on the position only; a caller that
    runs many layers at one position (``lm.decode_step``) builds them once
    and passes them in, else they are built here."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    B = x.shape[0]
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt = x.dtype
    C = cache.k.shape[1]
    pos = cache.length  # position of the new token
    q = (x @ p["wq"].to(dt)).reshape(B, 1, h, hd)
    k = (x @ p["wk"].to(dt)).reshape(B, 1, kvh, hd)
    v = (x @ p["wv"].to(dt)).reshape(B, 1, kvh, hd)
    if use_rope:
        if angles is None:
            angles = rope_angles(torch.full((1,), pos, dtype=torch.int32,
                                            device=x.device),
                                 hd, cfg.rope_theta)
        q, k = _rotate(q, *angles), _rotate(k, *angles)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    qs = q.reshape(B, h, hd).float() * scale
    placements = getattr(cache.k, "placements", None)  # a DTensor's
    if placements is not None and any(pl.is_shard(1) for pl in placements):
        o = _decode_sequence_sharded(qs, k, v, cache, window, dt)
    else:
        slot = pos % C
        cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
        cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
        if valid is None:
            valid = ring_valid(pos, C, window, x.device).expand(B, C)
        # the reference reads the cache in the compute dtype, then in
        # float32
        kk = cache.k if cache.k.dtype == dt else cache.k.to(dt)
        vv = cache.v if cache.v.dtype == dt else cache.v.to(dt)
        core = flash_decode if backend == "cuda" else flash_decode_torch
        o = core(qs, kk, vv, valid)
    out = o.reshape(B, 1, h * hd).to(dt) @ p["wo"].to(dt)
    return out, KVCache(cache.k, cache.v, pos + 1)


def _decode_sequence_sharded(qs, k, v, cache: KVCache,
                             window: Optional[int], dt):
    """The decode core over a ``DTensor`` cache sharded along its
    sequence (dim 1) over some mesh axes: the new token's K and V are
    written by the shard that holds slot ``length % C``; each shard takes
    the plain version's masked scores over its own positions, their row
    max, the sum of their exponentials and the weighted V (the cache read
    in the compute dtype ``dt``, then in float32); an all-reduce
    of the maxima and one of the rescaled sums and outputs over the
    sequence axes merge them.  Heads stay sharded as the cache's kv heads
    are.  Returns the (B, H, hd) float32 output as a ``DTensor``."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = cache.k.device_mesh
    kp = tuple(cache.k.placements)
    B, C, _, hd = cache.k.shape
    seq_dims = [d for d, pl in enumerate(kp) if pl.is_shard(1)]
    shards = math.prod(mesh.size(d) for d in seq_dims)
    coord = mesh.get_coordinate()
    index = 0
    for d in seq_dims:  # the shard's index along C, major to minor
        index = index * mesh.size(d) + coord[d]
    C_l = C // shards
    first, slot = index * C_l, cache.length % C
    new = tuple(Replicate() if pl.is_shard(1) else pl for pl in kp)

    def local(t, placements):
        if tuple(t.placements) != placements:
            t = t.redistribute(mesh, placements)
        return t.to_local()

    k_l, v_l = cache.k.to_local(), cache.v.to_local()
    if first <= slot < first + C_l:
        k_l[:, slot - first] = local(k, new)[:, 0].to(k_l.dtype)
        v_l[:, slot - first] = local(v, new)[:, 0].to(v_l.dtype)
    valid = ring_valid(cache.length, C, window, k_l.device)
    valid = valid[first:first + C_l].expand(k_l.shape[0], C_l)
    qp = tuple(Shard(1) if pl.is_shard(2) else
               Replicate() if pl.is_shard(1) else pl for pl in kp)
    q_l = local(qs, qp)
    Bl, Hl = q_l.shape[:2]
    Hkv_l = k_l.shape[2]
    qg = q_l.reshape(Bl, Hkv_l, Hl // Hkv_l, hd)
    s = torch.einsum("bkgd,bckd->bkgc", qg, k_l.to(dt).float())
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bkgc,bckd->bkgd", p, v_l.to(dt).float())
    m_all = m
    for d in seq_dims:
        m_all = funcol.all_reduce(m_all, "max", (mesh, d))
    w = torch.exp(m - m_all)
    packed = torch.cat([o * w[..., None], (p.sum(dim=-1) * w)[..., None]],
                       dim=-1)
    for d in seq_dims:
        packed = funcol.all_reduce(packed, "sum", (mesh, d))
    o = (packed[..., :hd] / packed[..., hd:]).reshape(Bl, Hl, hd)
    return DTensor.from_local(o, mesh, qp, run_check=False, shape=qs.shape,
                              stride=qs.stride())


def prefill_kv(p, x, cfg: ModelConfig, max_seq: int,
               window: Optional[int] = None) -> KVCache:
    """Build a cache from a full prompt x (B,S,d)."""
    B, S, _ = x.shape
    kvh, hd = cfg.num_kv_heads, cfg.hd
    dt = x.dtype
    k = (x @ p["wk"].to(dt)).reshape(B, S, kvh, hd)
    v = (x @ p["wv"].to(dt)).reshape(B, S, kvh, hd)
    k = rope(k, torch.arange(S, dtype=torch.int32, device=x.device),
             cfg.rope_theta)
    cache = init_kv_cache(cfg, B, max_seq, window, dtype=dt, device=x.device)
    C = cache.k.shape[1]
    take = min(S, C)
    # ring invariant: absolute position t lives in slot t mod C
    slots = (torch.arange(take, device=x.device) + (S - take)) % C
    cache.k[:, slots] = k[:, S - take:].to(cache.k.dtype)
    cache.v[:, slots] = v[:, S - take:].to(cache.v.dtype)
    return KVCache(cache.k, cache.v, S)
