"""The training step: microbatched gradient accumulation, then optional
IDEALEM gradient compression with error feedback, then AdamW.

The counterpart of ``repro/train/step.py``, in its order of operations.
Where the reference jits the step and scans the microbatches, the port
runs a plain function and a Python loop; the forward rematerialises each
super-block of layers under ``cfg.remat`` (``models.lm``), so the
activations kept scale with the microbatch.  Parameters are float32
masters (``lm.init_params(..., masters=True)``), cast to ``cfg.dtype`` at
each use.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.common import ModelConfig, logical, replicated
from ..models.convert import _split, params_from_jax
from ..models.lm import init_params, lm_loss
from ..optim import adamw, gradcomp
from ..tree import tree_leaves, tree_unflatten

__all__ = ["TrainState", "init_train_state", "make_train_step",
           "train_state_from_jax"]


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    gradcomp: Optional[gradcomp.GradCompState]


def init_train_state(cfg: ModelConfig,
                     generator: Optional[torch.Generator] = None,
                     device=None, use_gradcomp: bool = False) -> TrainState:
    """Float32 master parameters drawn from ``generator`` on ``device``
    (default the card), zero AdamW moments, and a zero residual with
    ``use_gradcomp``."""
    params = init_params(cfg, generator, resolve_device(device),
                         masters=True)
    gc = gradcomp.init(params) if use_gradcomp else None
    return TrainState(params, adamw.init(params), gc)


def train_state_from_jax(state, cfg: ModelConfig, device=None) -> TrainState:
    """The port's :class:`TrainState` from a reference ``TrainState``
    converted with ``jax.tree.map(np.asarray, state)``: parameters in the
    trainer's layout (``params_from_jax`` with ``masters=True``), the
    AdamW step as a 0-d int32 tensor, ``mu``, ``nu`` and the gradient
    compressor's residual (or None) in float32, split per layer as the
    parameters are."""
    dev = resolve_device(device)

    def f32(tree):
        return _split(tree, cfg, dev, lambda _: torch.float32)

    opt = adamw.AdamWState(
        torch.as_tensor(np.array(state.opt.step), dtype=torch.int32,
                        device=dev),
        f32(state.opt.mu), f32(state.opt.nu))
    gc = None if state.gradcomp is None else gradcomp.GradCompState(
        f32(state.gradcomp.residual))
    return TrainState(params_from_jax(state.params, cfg, dev, masters=True),
                      opt, gc)


def _on(dev, v):
    """A batch leaf (numpy or tensor) on ``dev``: token ids as int64."""
    t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                        else v)
    if not t.is_floating_point():
        t = t.long()
    return t.to(dev)


def _microbatched(v, microbatches: int):
    """(B, ...) -> (microbatches, B / microbatches, ...): microbatch i is
    rows ``i * size:(i + 1) * size``, as the reference's scan takes them.
    Under a mesh (``models.common.logical``) the batch is gathered once a
    step and each microbatch's rows are laid over the batch axes, where
    slicing a batch-sharded batch would gather it for every microbatch
    (and a reshape of the sharded dim would take a layout that depends
    on the microbatch count)."""
    v = replicated(v).reshape((microbatches, -1) + tuple(v.shape[1:]))
    return logical(v, None, "batch", *([None] * (v.dim() - 2)))


def make_train_step(cfg: ModelConfig, *, lr=3e-4, microbatches: int = 1,
                    weight_decay: float = 0.1, clip_norm: float = 1.0,
                    use_gradcomp: bool = False,
                    gradcomp_kw: Optional[dict] = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` is a dict of (B, ...) arrays or tensors (``tokens``,
    ``labels``, and ``memory`` or ``frames`` where the family needs them),
    B divisible by ``microbatches``.  The gradients of the microbatches
    are summed in float32 with their losses, both scaled by
    ``1 / microbatches``; then gradient compression (``use_gradcomp``),
    then AdamW.  ``metrics``: ``loss``, ``grad_norm``, ``lr`` (and
    ``hit_rate``, ``wire_ratio``), 0-d tensors on the device."""

    def train_step(state: TrainState, batch):
        leaves = tree_leaves(state.params)
        dev = leaves[0].device
        batch = {k: _on(dev, v) for k, v in batch.items()}
        b = next(iter(batch.values())).shape[0]
        if b % microbatches:
            raise ValueError(f"batch of {b} rows in {microbatches} "
                             f"microbatches")
        split = {k: _microbatched(v, microbatches) for k, v in batch.items()}
        # zeros_like: a sharded parameter's sum takes its layout
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(microbatches):
            mb = {k: v[i] for k, v in split.items()}
            with torch.enable_grad():
                ps = [p.detach().requires_grad_(True) for p in leaves]
                loss = lm_loss(tree_unflatten(state.params, ps), mb, cfg)
                g = torch.autograd.grad(loss, ps, allow_unused=True)
            for acc, gi in zip(grads, g):
                if gi is not None:  # a leaf the loss does not read: zero
                    acc.add_(gi.float())
            loss_sum = loss_sum + loss.detach()
        inv = 1.0 / microbatches
        grads = tree_unflatten(state.params, [gr * inv for gr in grads])
        metrics = {"loss": loss_sum * inv}
        gc_state = state.gradcomp
        if use_gradcomp:
            grads, gc_state, gc_metrics = gradcomp.compress(
                grads, gc_state, **(gradcomp_kw or {}))
            metrics.update(gc_metrics)
        params, opt, opt_metrics = adamw.update(
            grads, state.opt, state.params, lr=lr,
            weight_decay=weight_decay, clip_norm=clip_norm)
        metrics.update(opt_metrics)
        return TrainState(params, opt, gc_state), metrics

    return train_step
