"""Carry the reference package's parameters across to the port.

:func:`params_from_jax` takes the pytree of ``repro.models.lm.init_params``
as numpy arrays (``jax.tree.map(np.asarray, params)``: the port imports no
jax) and returns the port's layout: each stage's stacked ``p{i}`` leaves
split into one dict per layer, in the order the reference's scan visits
them (an empty dict for zamba2's shared-attention layers, whose block is
carried once as ``"shared"``), and the whisper encoder's stacked stage
split into ``"encoder": {"layers", "norm"}``.

Dtypes: the leaves the reference reads in float32 keep
``cfg.param_dtype``: the embedding, every norm scale (``norm1``,
``norm2``, ``norm_x``, ``ssm.norm``, ``tm.ln_out``, the final and encoder
norms), the MoE router, the SSM's ``A_log``, ``D``, ``dt_bias`` and
``conv_w`` (the decode reads them in float32) and RWKV's ``w0`` and
``u``.  Every other leaf is cast once to ``cfg.dtype``, the dtype the
reference casts it to before every product.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from .common import ModelConfig
from .lm import stage_plan

__all__ = ["params_from_jax"]

#: Leaves kept in ``cfg.param_dtype`` (by name, at any depth).
_FLOAT32_LEAVES = frozenset(
    {"scale", "router", "A_log", "D", "dt_bias", "conv_w", "w0", "u"})


def _tensor(a, dtype, dev):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev, dtype)


def _convert(tree, r: Optional[int], cfg: ModelConfig, dev):
    """A nested dict of arrays (entry ``r`` of a stacked one) in the port's
    dtypes."""
    out = {}
    for name, a in tree.items():
        if isinstance(a, dict):
            out[name] = _convert(a, r, cfg, dev)
        else:
            dt = cfg.param_dtype if name in _FLOAT32_LEAVES else cfg.dtype
            out[name] = _tensor(a if r is None else a[r], dt, dev)
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
            for i, kind in enumerate(pattern):
                layers.append({} if kind == "shared_attn"
                              else _convert(stage[f"p{i}"], r, cfg, dev))
    out = {
        "embed": {k: _tensor(a, cfg.param_dtype, dev)
                  for k, a in tree["embed"].items()},
        "final_norm": _convert(tree["final_norm"], None, cfg, dev),
        "layers": layers,
    }
    if "shared" in tree:
        out["shared"] = _convert(tree["shared"], None, cfg, dev)
    if "encoder" in tree:
        stage = tree["encoder"]["stage"]["p0"]
        out["encoder"] = {
            "layers": [_convert(stage, r, cfg, dev)
                       for r in range(cfg.encoder_layers)],
            "norm": _convert(tree["encoder"]["norm"], None, cfg, dev)}
    return out
