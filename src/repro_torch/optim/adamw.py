"""AdamW with decoupled weight decay, global-norm clipping and float32
moments: the counterpart of ``repro/optim/adamw.py``, over the port's
parameter trees (``repro_torch.tree``) with plain tensor ops.

The step count is a 0-d int32 tensor on the parameters' device, so no
update waits on the host.  Updates are functional: the state and
parameters passed in are not modified (the fault-tolerant trainer keeps
the old state when a step fails).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWState", "init", "global_norm", "update", "warmup_cosine"]


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    mu: Any
    nu: Any


def init(params) -> AdamWState:
    """Zero moments in float32 and step 0, on the parameters' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      tree_map(zeros, params), tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of the float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


def update(grads, state: AdamWState, params, *, lr, b1: float = 0.9,
           b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
           clip_norm: Optional[float] = 1.0):
    """One AdamW step: ``(params, state, {"grad_norm", "lr"})``.  ``lr``:
    a float or a callable of the new step (0-d tensor), as
    :func:`warmup_cosine` returns.  Gradients are scaled by
    ``min(1, clip_norm / max(norm, 1e-9))`` first; the bias corrections
    are taken in float32."""
    step = state.step + 1
    lr_t = lr(step) if callable(lr) else lr
    gn = global_norm(grads)
    if clip_norm is not None:
        scale = torch.clamp(clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
        grads = tree_map(lambda g: g * scale, grads)
    t = step.float()
    bc1, bc2 = 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)

    def upd(g, m, v, p):
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) \
            + weight_decay * p.float()
        return (p.float() - lr_t * delta).to(p.dtype), m, v

    outs = [upd(*xs) for xs in zip(*(tree_leaves(t) for t in (
        grads, state.mu, state.nu, params)))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in outs])
                           for i in range(3))
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gn,
                                                  "lr": lr_t}


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable:
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor * peak_lr`` at ``total``; of a step (tensor or
    number), in float32."""
    def sched(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return sched
