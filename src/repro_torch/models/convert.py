"""Carry the reference package's parameters across to the port.

:func:`params_from_jax` takes the pytree of ``repro.models.lm.init_params``
as numpy arrays (``jax.tree.map(np.asarray, params)``: the port imports no
jax) and returns the port's layout: each stage's stacked ``p{i}`` leaves
split into one dict per layer, in the order the reference's scan visits
them.  The norm scales and the embedding table keep ``cfg.param_dtype``;
the projection and MLP weights are cast once to ``cfg.dtype``, the dtype
the reference casts them to before every product.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve_device
from .common import ModelConfig
from .lm import stage_plan

__all__ = ["params_from_jax"]

_NORMS = ("norm1", "norm2")  # kept in cfg.param_dtype


def _tensor(a, dtype, dev):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev, dtype)


def _layer(tree, r: int, cfg: ModelConfig, dev) -> Dict[str, Any]:
    out = {}
    for group, leaves in tree.items():
        dt = cfg.param_dtype if group in _NORMS else cfg.dtype
        out[group] = {name: _tensor(a[r], dt, dev)
                      for name, a in leaves.items()}
    return out


def params_from_jax(tree, cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """The port's parameters (``models.lm.init_params`` layout) on
    ``device`` (default the card) from the reference's parameter tree of
    numpy arrays for the same ``cfg``."""
    dev = resolve_device(device)
    plan = stage_plan(cfg)
    if len(tree["stages"]) != len(plan):
        raise ValueError(f"{len(tree['stages'])} stages in the tree, "
                         f"{len(plan)} in the plan of {cfg.name!r}")
    layers = []
    for stage, (pattern, reps) in zip(tree["stages"], plan):
        for r in range(reps):
            for i in range(len(pattern)):
                layers.append(_layer(stage[f"p{i}"], r, cfg, dev))
    return {
        "embed": {k: _tensor(a, cfg.param_dtype, dev)
                  for k, a in tree["embed"].items()},
        "final_norm": {"scale": _tensor(tree["final_norm"]["scale"],
                                        cfg.param_dtype, dev)},
        "layers": layers,
    }
