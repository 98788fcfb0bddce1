"""Model configuration, parameter initialization and logical sharding of
the LM.

The counterpart of ``repro/models/common.py``: the same :class:`ModelConfig`
fields and defaults, with torch dtypes, and the logical-axis rules.  The
launcher (``launch/dryrun.py``) registers rules mapping logical axis names
("batch", "heads", "ff", ...) to mesh axes; model code marks its
activations with :func:`logical`.  With no rules registered (every serve
and train run) :func:`logical` returns its input after one global check.
With rules, a ``DTensor`` is redistributed to the rule's placements, as the
reference's ``with_sharding_constraint`` constrains it.

The port's layers are never stacked: ``scan_layers`` selects how the dry
run counts a stage's repeats (trace one and multiply, as the reference's
HLO trip counts do, or trace every layer), and nothing else reads it.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

__all__ = ["ModelConfig", "dense_init", "set_sharding_rules",
           "get_sharding_rules", "logical", "batch_local", "shard_local",
           "unstacked", "replicated"]


@dataclass(frozen=True)
class ModelConfig:
    """The reference's fields, letter for letter
    (``repro/models/common.py:18-76``)."""
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 512
    vocab_size: int = 256
    head_dim: Optional[int] = None
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # Expert-parallel sharding of the expert dim (the reference's default:
    # off, FFN tensor parallelism inside the experts instead)
    moe_expert_parallel: bool = False
    # attention pattern
    sliding_window: Optional[int] = None   # SWA on all attention layers
    local_global_ratio: int = 0            # N local layers per global
    local_window: int = 1024
    # ssm / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    attn_every: int = 0                    # zamba2: shared attn every k layers
    # vlm
    cross_attn_every: int = 0
    num_image_tokens: int = 0
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0
    # misc
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    act: str = "swiglu"  # swiglu | gelu
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    remat_policy: str = "full"  # full | dots (save unbatched matmul outputs)
    scan_layers: bool = True     # dry run: trace one repeat of a stage
    train_microbatches: int = 8  # grad-accumulation steps at train_4k scale
    rwkv_chunk: int = 64
    ssm_chunk: int = 128
    attn_chunk: int = 1024

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Total parameter count N, counted from the shapes of
        :func:`repro_torch.models.lm.init_params` on the meta device (no
        memory is allocated)."""
        from ..tree import tree_leaves
        from .lm import init_params  # lazy; avoids a cycle
        params = init_params(self, device="meta")
        return sum(math.prod(t.shape) for t in tree_leaves(params))

    def active_param_count(self) -> int:
        """Parameters active per token: a MoE counts ``experts_per_token``
        of its ``num_experts`` experts (the reference's integer rounding)."""
        from ..tree import tree_leaves
        from .lm import init_params
        params = init_params(self, device="meta")
        total = sum(math.prod(t.shape) for t in tree_leaves(params))
        if self.num_experts == 0:
            return total
        expert = sum(math.prod(t.shape) for layer in params["layers"]
                     for name, t in layer.get("moe", {}).items()
                     if "experts" in name)
        frac = self.experts_per_token / self.num_experts
        return int(total - expert + expert * frac)


def dense_init(shape, in_axis: int = 0, dtype=torch.float32,
               generator: Optional[torch.Generator] = None,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: a standard normal truncated to [-2, 2],
    scaled by ``fan_in ** -0.5``, drawn from ``generator`` on ``device`` in
    float32 and cast to ``dtype``.  The numbers differ from the reference's
    ``jax.random.truncated_normal`` for the same seed; tests carry the
    reference's weights across instead (``models.convert``)."""
    fan_in = shape[in_axis] if len(shape) else 1
    scale = 1.0 / max(fan_in, 1) ** 0.5
    t = torch.empty(shape, dtype=torch.float32, device=device)
    # inverse-CDF sampling, as torch.nn.init.trunc_normal_ does
    lo, hi = (math.erf(-2.0 / math.sqrt(2.0)) + 1) / 2, \
        (math.erf(2.0 / math.sqrt(2.0)) + 1) / 2
    t.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    t.erfinv_().mul_(math.sqrt(2.0) * scale)
    t.clamp_(-2.0 * scale, 2.0 * scale)
    return t.to(dtype)


# ---------------------------------------------------------- logical sharding

_RULES: Optional[dict] = None


def set_sharding_rules(rules: Optional[dict]) -> None:
    """rules: logical axis name -> mesh axis (str | tuple | None); None
    removes them."""
    global _RULES
    _RULES = rules


def get_sharding_rules() -> Optional[dict]:
    return _RULES


def logical(x, *axes: Optional[str], grad: bool = False):
    """Constrain ``x``'s layout by logical axis names, one a dim (None:
    replicated).  Without rules, ``x`` itself.  With rules, a ``DTensor``
    is redistributed to the placements the rules give its mesh (a mesh
    axis that does not divide its dim is dropped, as the sharding policy
    drops it); a plain tensor is returned as it is.  ``grad=True`` lays
    the gradient out alike (:class:`_Pin`)."""
    if _RULES is None:
        return x
    return _constrain(x, axes, _RULES, grad)


def _constrain(x, axes, rules, grad):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    placements = [Replicate()] * mesh.ndim
    for dim, axis in enumerate(axes):
        mesh_axes = rules.get(axis) if axis is not None else None
        if mesh_axes is None:
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        if x.shape[dim] % math.prod(mesh.size(names.index(a))
                                    for a in mesh_axes):
            continue
        for a in mesh_axes:
            placements[names.index(a)] = Shard(dim)
    placements = tuple(placements)
    if grad and x.requires_grad and torch.is_grad_enabled():
        return _Pin.apply(x, placements)
    if placements == tuple(x.placements):
        return x
    return x.redistribute(mesh, placements)


class _Pin(torch.autograd.Function):
    """A ``DTensor`` and its gradient laid out alike (GSPMD transposes a
    sharding constraint into the same constraint on the cotangent): the
    value redistributed to ``placements`` going forward, the gradient
    going back -- a pending sum reduced there, as the reference's
    partitioner reduces it, instead of meeting the next product and
    making it gather its weights."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        if placements == tuple(x.placements):
            return x
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) == ctx.placements:
            return grad, None
        return grad.redistribute(grad.device_mesh, ctx.placements), None


def batch_local(fn, *args):
    """``fn(*args)`` on each batch shard.  Plain tensors: ``fn(*args)``.
    With ``DTensor`` arguments (all of batch size B in dim 0), each is laid
    out with dim 0 over the rules' batch axes (where they divide B) and
    replicated over the other mesh axes -- a counted redistribution where
    it was laid out otherwise -- ``fn`` runs on the local shards, and its
    tensor outputs are ``DTensor``s in that layout.  For operations whose
    indices address batch rows (the MoE's scatter into and gather from its
    expert buffers), which GSPMD partitions batch-locally and ``DTensor``
    would gather whole."""
    if not any(hasattr(a, "placements") for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    names = mesh.mesh_dim_names
    axes = (_RULES or {}).get("batch") or ()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    B = args[0].shape[0]
    placements = [Replicate()] * mesh.ndim
    if axes and B % math.prod(mesh.size(names.index(a)) for a in axes) == 0:
        for a in axes:
            placements[names.index(a)] = Shard(0)
    placements = tuple(placements)
    return _on_shards(fn, [a.redistribute(mesh, placements).to_local()
                           if isinstance(a, DTensor) else a for a in args],
                      mesh, placements)


def shard_local(fn, *args, grad_placements=None):
    """``fn(*args)`` on each chip's shards of ``DTensor`` arguments; plain
    tensors: ``fn(*args)``.  ``fn`` runs on the local shards and its
    tensor outputs are ``DTensor``s laid out as the first ``DTensor``
    argument.  For a computation independent along every dim that its
    output is split on: the attention core, laid out by batch and heads
    (or by batch and queries), whose products ``DTensor`` would run on
    every head, since they flatten the two split dims into one.
    ``grad_placements``: one entry an argument, the layout of the gradient
    of its local shard where it is not the argument's own (a pending sum
    for a replicated operand that each chip reads whole)."""
    from torch.distributed.tensor import DTensor
    tensors = [a for a in args if isinstance(a, DTensor)]
    if not tensors:
        return fn(*args)
    mesh, placements = tensors[0].device_mesh, tuple(tensors[0].placements)
    grads = grad_placements or [None] * len(args)
    return _on_shards(fn, [a.to_local(grad_placements=g)
                           if isinstance(a, DTensor) else a
                           for a, g in zip(args, grads)], mesh, placements)


def _on_shards(fn, local_args, mesh, placements):
    from torch.distributed.tensor import DTensor
    out = fn(*local_args)

    def wrap(t):
        return DTensor.from_local(t, mesh, placements, run_check=False)
    if isinstance(out, tuple):
        return tuple(wrap(t) for t in out)
    return wrap(out)


def unstacked(x):
    """``x`` itself, or for a ``DTensor`` whose tensor dim is sharded over
    several mesh dims (the batch over ("pod", "data")), that dim sharded
    over the first of them only, replicated over the others (a counted
    all-gather): for an operation whose sharding rules take no dim
    sharded twice (the embedding gather's token ids)."""
    placements = getattr(x, "placements", None)
    if placements is None:
        return x
    from torch.distributed.tensor import Replicate
    seen, out = set(), []
    for p in placements:
        if p.is_shard() and p.dim in seen:
            out.append(Replicate())
            continue
        if p.is_shard():
            seen.add(p.dim)
        out.append(p)
    if out == list(placements):
        return x
    return x.redistribute(x.device_mesh, out)


def replicated(x):
    """``x`` itself, or a ``DTensor`` replicated over every mesh axis (a
    counted all-gather): the embedding gather takes its table whole.
    With the table sharded along the vocabulary (or resharded so by
    ``DTensor``'s cost model), ``DTensor``'s vocabulary-parallel rule
    leaves a pending masked reduction whose gradient some torch releases
    cannot redistribute."""
    placements = getattr(x, "placements", None)
    if placements is None or all(p.is_replicate() for p in placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * len(placements))
