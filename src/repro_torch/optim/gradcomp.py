"""IDEALEM gradient compression with error feedback: the counterpart of
``repro/optim/gradcomp.py``.

The gradient tree (plus the residual of the last step) is flattened into
one float32 vector in ``jax.tree`` leaf order and cut into blocks of
``block`` values.  The paper's FIFO-dictionary encode scan decides each
block: a block exchangeable with a dictionary entry (two-sample KS behind
the min/max gate) goes on the wire as a one-byte index, and the receiver
substitutes that entry, the most recent miss stored in the slot.
Gradients are order-sensitive, so a hit is duplicated, not permuted, and
the error is fed back into the next step's gradient.

The decisions come from ``core.encoder.encode_decisions(...,
matcher="fused")``: on the card one K1 launch over the whole flattened
gradient (chunked through the resumable carry where one launch would
pass K1's int32 index range), on CPU tensors K1's plain version; both
decide as the reference's scan.  The hit's source block is found on the
device with a sort and a running maximum (:func:`hit_sources`), where the
reference scans every block.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..core.encoder import encode_decisions, init_state
from ..core.ks import critical_distance
from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["GradCompState", "init", "compress", "hit_sources"]

#: K1 indexes its blocks operand with int32: one launch takes fewer than
#: this many values (``kernels/encode_step.py:_check``).
K1_ELEMENTS = 2 ** 31


class GradCompState(NamedTuple):
    residual: Any  # error-feedback accumulator, float32, mirrors params


def init(params) -> GradCompState:
    return GradCompState(tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def hit_sources(is_hit: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """For each block, the block whose values the receiver holds for it:
    itself for a miss, for a hit the last miss ``j <= i`` stored in its
    slot.  Every slot's first use is a miss (a hit needs a filled slot),
    so a running maximum of ``slot * nb + j`` over the misses, taken in
    (slot, block) order, gives it."""
    nb = is_hit.numel()
    i = torch.arange(nb, device=is_hit.device)
    base = slot.long() * nb
    key = base + i
    order = torch.argsort(key)
    last = torch.cummax(torch.where(is_hit, -1, key)[order], dim=0).values
    src = torch.empty_like(i)
    src[order] = last - base[order]
    return src


def _decide(blocks, *, num_dict: int, d_crit: float, rel_tol: float):
    """K1's decisions over ``blocks`` (nb, n), in as few launches as its
    index range allows, the carry threaded between them."""
    nb, n = blocks.shape
    step = max((K1_ELEMENTS - 1) // n, 1)
    state = init_state(num_dict, n, device=blocks.device)
    hits, slots = [], []
    for lo in range(0, nb, step):
        (h, s, _), state = encode_decisions(
            blocks[lo:lo + step], num_dict=num_dict, d_crit=d_crit,
            rel_tol=rel_tol, matcher="fused", state=state)
        hits.append(h)
        slots.append(s)
    if not hits:
        return (torch.zeros(0, dtype=torch.bool, device=blocks.device),
                torch.zeros(0, dtype=torch.int32, device=blocks.device))
    return torch.cat(hits), torch.cat(slots)


def _compress_flat(flat: torch.Tensor, *, block: int, num_dict: int,
                   d_crit: float, rel_tol: float):
    """``(reconstruction, metrics, (is_hit, slot))`` of a float32 vector:
    its whole blocks as the receiver rebuilds them, the tail as is."""
    nb = flat.numel() // block
    blocks = flat[:nb * block].reshape(nb, block)
    is_hit, slot = _decide(blocks, num_dict=num_dict, d_crit=d_crit,
                           rel_tol=rel_tol)
    recon = torch.cat([blocks[hit_sources(is_hit, slot)].reshape(-1),
                       flat[nb * block:]])
    hits = is_hit.sum()
    bytes_orig = torch.tensor(nb * block * 4, dtype=torch.float32,
                              device=flat.device)
    bytes_wire = hits.float() * 1.0 + (nb - hits).float() * (block * 4.0
                                                             + 1.0)
    metrics = {"hit_rate": hits.float() / max(nb, 1),
               "wire_ratio": bytes_orig / torch.clamp(bytes_wire, min=1.0)}
    return recon, metrics, (is_hit, slot)


def compress(grads, state: GradCompState, *, block: int = 256,
             num_dict: int = 32, alpha: float = 0.05,
             rel_tol: float = 0.5) -> Tuple[Any, GradCompState, dict]:
    """grads + error feedback -> (transmitted grads, new state, metrics
    ``hit_rate`` and ``wire_ratio``, float32): one byte a hit block, 4 *
    ``block`` + 1 a miss, against 4 * ``block`` a block uncompressed."""
    d_crit = critical_distance(alpha, block, block)
    leaves = tree_leaves(grads)
    flat = torch.cat([(g.float() + r.float()).reshape(-1) for g, r in
                      zip(leaves, tree_leaves(state.residual))])
    recon, metrics, _ = _compress_flat(
        flat, block=block, num_dict=num_dict, d_crit=float(d_crit),
        rel_tol=rel_tol)
    err = flat - recon
    out, res, off = [], [], 0
    for g in leaves:
        sz = g.numel()
        out.append(recon[off:off + sz].reshape(g.shape).to(g.dtype))
        res.append(err[off:off + sz].reshape(g.shape))
        off += sz
    return (tree_unflatten(grads, out),
            GradCompState(tree_unflatten(grads, res)), metrics)
