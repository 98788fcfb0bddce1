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
reference casts it to before every product.  ``masters=True`` keeps every
leaf in ``cfg.param_dtype`` instead: the trainer's layout, in which the
forward's cast at each use is the reference's and gradients reach the
float32 masters.
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
    {"table", "unembed", "scale", "router", "A_log", "D", "dt_bias",
     "conv_w", "w0", "u"})


def _tensor(a, dtype, dev):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev, dtype)


def _cast(tree, r: Optional[int], dtype_of, dev):
    """A nested dict of arrays (entry ``r`` of a stacked one), each leaf in
    ``dtype_of(name)``."""
    out = {}
    for name, a in tree.items():
        if isinstance(a, dict):
            out[name] = _cast(a, r, dtype_of, dev)
        else:
            out[name] = _tensor(a if r is None else a[r], dtype_of(name), dev)
    return out


def _dtypes(cfg: ModelConfig, masters: bool = False):
    """The dtype of a leaf by name: ``cfg.param_dtype`` for the float32
    leaves (all of them with ``masters``), else ``cfg.dtype``."""
    def dtype_of(name):
        return cfg.param_dtype if masters or name in _FLOAT32_LEAVES \
            else cfg.dtype
    return dtype_of


def _convert(tree, r: Optional[int], cfg: ModelConfig, dev):
    """:func:`_cast` in the serve layout's dtypes."""
    return _cast(tree, r, _dtypes(cfg), dev)


def _split(tree, cfg: ModelConfig, dev, dtype_of) -> Dict[str, Any]:
    """The port's per-layer layout of a reference-structured tree."""
    plan = stage_plan(cfg)
    if len(tree["stages"]) != len(plan):
        raise ValueError(f"{len(tree['stages'])} stages in the tree, "
                         f"{len(plan)} in the plan of {cfg.name!r}")
    layers = []
    for stage, (pattern, reps) in zip(tree["stages"], plan):
        for r in range(reps):
            for i, kind in enumerate(pattern):
                layers.append({} if kind == "shared_attn"
                              else _cast(stage[f"p{i}"], r, dtype_of, dev))
    out = {
        "embed": _cast(tree["embed"], None, dtype_of, dev),
        "final_norm": _cast(tree["final_norm"], None, dtype_of, dev),
        "layers": layers,
    }
    if "shared" in tree:
        out["shared"] = _cast(tree["shared"], None, dtype_of, dev)
    if "encoder" in tree:
        stage = tree["encoder"]["stage"]["p0"]
        out["encoder"] = {
            "layers": [_cast(stage, r, dtype_of, dev)
                       for r in range(cfg.encoder_layers)],
            "norm": _cast(tree["encoder"]["norm"], None, dtype_of, dev)}
    return out


def params_from_jax(tree, cfg: ModelConfig, device=None,
                    masters: bool = False) -> Dict[str, Any]:
    """The port's parameters (``models.lm.init_params`` layout) on
    ``device`` (default the card) from the reference's parameter tree of
    numpy arrays for the same ``cfg``; ``masters=True``: every leaf in
    ``cfg.param_dtype`` (the trainer's layout)."""
    return _split(tree, cfg, resolve_device(device), _dtypes(cfg, masters))
