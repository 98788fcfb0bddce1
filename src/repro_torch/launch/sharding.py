"""Sharding policy: path-based partition specs for parameters, optimizer
state, caches and batches, and their ``DTensor`` placements.

The counterpart of ``repro/launch/sharding.py``, rule for rule.  Baseline
layout (Megatron TP x FSDP/ZeRO-1):
  - ``model`` axis: attention head projections, FFN hidden, vocab,
    (experts).
  - ``data`` axis: FSDP shard of every large parameter's other big dim;
    the optimizer state mirrors the parameter specs (ZeRO-1).
  - batch dims: ('pod', 'data') multi-pod, ('data',) single-pod.
  - long-context decode (batch=1): the KV-cache *sequence* dim shards over
    the batch axes instead (sequence parallelism);
    ``models.attention.decode_attention`` then merges the shards' partial
    softmaxes with two all-reduces.

Axes are dropped when a dim is not divisible by the mesh axis size (the
layout stays clean; the tensor is replicated over that axis instead).

The rules apply to the port's per-layer trees (``models.lm.init_params``:
``layers[i]``, ``shared``, ``encoder.layers[i]``).  The reference's
stacked leaves carry a leading scan dim whose spec is ``None``; each of
the port's per-layer leaves gets the same spec without it.

A spec is a :class:`P`: one entry a tensor dim, each None (replicated), a
mesh axis name, or a tuple of names (sharded over their product, major to
minor).  ``mesh`` is a ``DeviceMesh`` or a mapping of axis name to size
(the specs need only the sizes, so they are computed without a process
group, as the reference computes them on an abstract mesh).
"""
from __future__ import annotations

import math
from typing import Any, Mapping

from ..models.common import ModelConfig

__all__ = ["P", "param_specs", "state_specs", "batch_specs", "cache_specs",
           "activation_rules", "to_placements", "to_shardings"]


class P(tuple):
    """A partition spec, entry for entry as ``jax.sharding.PartitionSpec``
    holds it (a one-name tuple stands as that name)."""

    def __new__(cls, *axes):
        return super().__new__(cls, (
            (a[0] if len(a) == 1 else tuple(a))
            if isinstance(a, (tuple, list)) else a for a in axes))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _sizes(mesh) -> Mapping[str, int]:
    if isinstance(mesh, Mapping):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(sizes, name) -> int:
    if name is None:
        return 1
    if isinstance(name, (tuple, list)):
        return math.prod(sizes[a] for a in name)
    return sizes[name]


def _fit(spec: P, shape, sizes) -> P:
    """Drop axes that don't divide the corresponding dim."""
    out = []
    for i, ax in enumerate(spec):
        if ax is None or i >= len(shape):
            out.append(None)
            continue
        out.append(ax if shape[i] % _axis_size(sizes, ax) == 0 else None)
    return P(*out)


def _map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over the tensor leaves of a tree of dicts,
    lists, tuples and NamedTuples; other leaves (ints, None) map to None."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                 for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return items
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return fn(path, tree)
    return None


# --------------------------------------------------------------- param rules
def _param_rule(name: str, ndim: int, ep: bool) -> P:
    """Spec of a parameter by its leaf name (the reference's
    ``_param_rule``)."""
    if name in ("wq", "wk", "wv", "up", "gate", "in_proj", "wr", "wg",
                "w_lora_a"):
        return P("data", "model")
    if name in ("wo", "down", "out_proj", "wv_cm", "w_lora_b"):
        return P("model", "data")
    if name == "table":      # (vocab, d): vocab on model, d FSDP
        return P("model", "data")
    if name == "unembed":    # (d, vocab)
        return P("data", "model")
    if name == "router":
        return P("data", None)
    if name in ("experts_up", "experts_gate"):  # (E, d, f)
        return P("model", "data", None) if ep else P(None, "data", "model")
    if name == "experts_down":  # (E, f, d)
        return P("model", None, "data") if ep else P(None, "model", "data")
    if name == "conv_w":
        return P(None, "model")
    if name == "u":
        return P("model", None)
    return P(*([None] * ndim))  # norms, biases, mu, scalars: replicated


def param_specs(params: Any, cfg: ModelConfig, mesh) -> Any:
    """A tree of :class:`P` matching a parameter tree (tensors on any
    device, ``meta`` included)."""
    sizes = _sizes(mesh)
    tp = sizes["model"]
    ep = (cfg.num_experts > 0 and cfg.num_experts % tp == 0
          and cfg.moe_expert_parallel)

    def rule(path, leaf):
        shape = tuple(leaf.shape)
        name = path.rsplit("/", 1)[-1]
        spec = _param_rule(name, len(shape), ep)
        # rwkv channel-mix wv is (ff, d): flip if its first dim is d_ff
        if name == "wv" and len(shape) == 2 and shape[0] == cfg.d_ff:
            spec = P("model", "data")
        return _fit(spec, shape, sizes)

    return _map_with_path(rule, params)


def state_specs(state: Any, cfg: ModelConfig, mesh) -> Any:
    """``TrainState`` specs: params, AdamW's mu and nu mirroring them, the
    step replicated, the gradient compressor's residual mirroring them."""
    from ..optim.adamw import AdamWState
    from ..optim.gradcomp import GradCompState
    from ..train.step import TrainState

    gc = state.gradcomp
    return TrainState(
        params=param_specs(state.params, cfg, mesh),
        opt=AdamWState(step=P(), mu=param_specs(state.opt.mu, cfg, mesh),
                       nu=param_specs(state.opt.nu, cfg, mesh)),
        gradcomp=None if gc is None else GradCompState(
            residual=param_specs(gc.residual, cfg, mesh)))


# --------------------------------------------------------------- batch rules
def batch_specs(batch: Any, mesh, baxes) -> Any:
    """Dim 0 of every batch tensor over the batch axes."""
    sizes = _sizes(mesh)

    def rule(path, leaf):
        spec = P(baxes, *([None] * (len(leaf.shape) - 1)))
        return _fit(spec, tuple(leaf.shape), sizes)

    return _map_with_path(rule, batch)


# --------------------------------------------------------------- cache rules
def cache_specs(cache: Any, cfg: ModelConfig, mesh, baxes,
                shard_sequence: bool) -> Any:
    """KV/state cache specs of a ``models.lm.DecodeCache``.
    ``shard_sequence=True`` (long-context, batch=1): the KV caches'
    sequence dim takes the batch axes (sequence parallelism).  Python-int
    lengths map to None."""
    from ..models.attention import KVCache
    from ..models.lm import DecodeCache
    from ..models.rwkv import RwkvCache
    from ..models.ssm import SSMCache

    sizes = _sizes(mesh)

    def fit(spec, t):
        return _fit(spec, tuple(t.shape), sizes)

    def rule(c):
        if isinstance(c, KVCache):
            seq = baxes if shard_sequence else None
            b = None if shard_sequence else baxes
            return KVCache(k=fit(P(b, seq, "model", None), c.k),
                           v=fit(P(b, seq, "model", None), c.v),
                           length=None)
        if isinstance(c, SSMCache):
            return SSMCache(state=fit(P(baxes, "model", None, None), c.state),
                            conv=fit(P(baxes, None, "model"), c.conv),
                            length=None)
        if isinstance(c, RwkvCache):
            return RwkvCache(
                state=fit(P(baxes, "model", None, None), c.state),
                last_tm=fit(P(baxes, None), c.last_tm),
                last_cm=fit(P(baxes, None), c.last_cm), length=None)
        if isinstance(c, dict):  # dec_attn: {"self", "cross"}
            return {k: rule(v) for k, v in c.items()}
        raise TypeError(f"no cache rule for {type(c).__name__}")

    mem = None if cache.memory is None else fit(P(baxes, None, None),
                                                cache.memory)
    return DecodeCache(tuple(rule(c) for c in cache.layers), mem, None)


# --------------------------------------------------- activations (logical())
def activation_rules(cfg: ModelConfig, mesh, baxes) -> dict:
    """Logical axis -> mesh axis rules for ``models.common.logical``."""
    tp = _sizes(mesh)["model"]
    ep = bool(cfg.num_experts and cfg.num_experts % tp == 0
              and cfg.moe_expert_parallel)
    return {
        "batch": baxes,
        "ff": "model" if cfg.d_ff % tp == 0 else None,
        "heads": "model" if cfg.num_heads % tp == 0 else None,
        "kv_heads": "model" if cfg.num_kv_heads % tp == 0 else None,
        "vocab": "model" if cfg.vocab_size % tp == 0 else None,
        "experts": "model" if ep else None,
        # expert-FFN dim takes the model axis only when experts don't (TP
        # inside experts vs EP across them -- never both on one tensor)
        "moe_ff": None if ep else ("model" if cfg.d_ff % tp == 0 else None),
        # the port's own axis: the attention core's queries take the model
        # axis where the heads do not divide it (models/attention.py:_attend)
        "queries": None if cfg.num_heads % tp == 0 else "model",
    }


# ------------------------------------------------------------- placements
def to_placements(spec: P, mesh) -> tuple:
    """``DTensor`` placements of a spec on ``mesh`` (a ``DeviceMesh``):
    ``Shard(dim)`` on every mesh dim that shards a tensor dim,
    ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    placements = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        for a in (ax if isinstance(ax, (tuple, list)) else (ax,)):
            placements[names.index(a)] = Shard(dim)
    return tuple(placements)


def to_shardings(spec_tree: Any, mesh) -> Any:
    """A tree of placements (tuples) matching a spec tree; None stays."""
    def walk(t):
        if t is None:
            return None
        if isinstance(t, P):
            return to_placements(t, mesh)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        items = [walk(v) for v in t]
        if isinstance(t, list):
            return items
        return type(t)(*items) if hasattr(t, "_fields") else type(t)(items)

    return walk(spec_tree)
