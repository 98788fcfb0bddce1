"""Per-chip cost counter of a traced step: FLOPs, bytes and collectives.

The counterpart of ``repro/launch/hlo_cost.py`` (the file keeps its name so
a reader finds the pair), but it counts the aten operations a step runs,
not HLO: :class:`CostCounter` is a ``TorchDispatchMode`` that sees every
operation on plain tensors -- the local shards of a ``DTensor`` program
(it declines the ``DTensor``-level call, so ``DTensor`` runs its local
operations and collectives under it), or the tensors of a one-device run,
on the meta device or on the card.  ``DTensor``'s own shape propagation
(fake tensors) is not counted.  It accumulates:

  - flops:       matmul FLOPs only, in the matmul convention (2*M*N*K), by
                 ``torch.utils.flop_counter``'s formulas on the local
                 shapes; elementwise operations are excluded, as in the
                 reference and in MFU accounting.
  - bytes:       operand plus result bytes of every operation that is not
                 a view or an allocation; gathers (``index``, ``gather``,
                 ``embedding``) count twice their result and scatters
                 (``index_put``, ``scatter``, ``*_scatter``, ``index_add``)
                 twice their update, as the reference's ``_SLICE_OPS`` do;
                 an in-place result is not counted again.  This is what
                 eager PyTorch moves through HBM on the card, operation by
                 operation; it is not XLA's fusion model, so it is not the
                 reference's number.
  - collectives: per kind, the count and the wire bytes a chip sends under
                 the reference's ring model (``dryrun.py:parse_collectives``),
                 n the group size: all-reduce 2(n-1)/n * size, all-gather
                 (n-1)/n * the gathered size, reduce-scatter (n-1) * the
                 shard, all-to-all (n-1)/n * size, collective-permute size.

A hand-written kernel, which no dispatch mode sees, reports its reckoned
cost itself through ``kernels._build.report_cost`` to every active counter
(K4: ``kernels/flash_decode.py``), on the meta device and on the card
alike, so a meta trace and a real step count the same thing.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels import _build

__all__ = ["CostCounter", "ring_wire_bytes", "analyze"]

aten = torch.ops.aten

# allocations and metadata: no bytes move
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten._unsafe_view, aten.lift_fresh_copy,
         aten._local_scalar_dense, aten.set_, aten.resize_}
# gathers: read the slice, write the result
_GATHERS = {aten.index, aten.gather, aten.index_select, aten.embedding,
            aten.take_along_dim}
# scatters: (op, position of the update operand)
_SCATTERS = {aten.index_put: 2, aten.index_put_: 2, aten._index_put_impl_: 2,
             aten.scatter: 3, aten.scatter_: 3, aten.scatter_add: 3,
             aten.scatter_add_: 3, aten.index_add: 3, aten.index_add_: 3,
             aten.slice_scatter: 1, aten.select_scatter: 1,
             aten.index_copy: 3, aten.index_copy_: 3}
# collective ops of the functional collectives (and DTensor's all-to-all):
# kind, and whether the ring model's size is the result's (all-gather, the
# gathered size; reduce-scatter, the shard) or the operand's
_COLLECTIVES = {
    "all_reduce": ("all-reduce", "in"),
    "all_reduce_": ("all-reduce", "in"),
    "all_gather_into_tensor": ("all-gather", "out"),
    "all_gather_into_tensor_out": ("all-gather", "out"),
    "reduce_scatter_tensor": ("reduce-scatter", "out"),
    "all_to_all_single": ("all-to-all", "in"),
    "shard_dim_alltoall": ("all-to-all", "in"),
    "permute_tensor": ("collective-permute", "in"),
}
_WAITS = {"wait_tensor", "_wrap_tensor_autograd"}


def ring_wire_bytes(kind: str, size: float, n: int) -> float:
    """Bytes a chip sends for one collective of ``size`` bytes over a
    group of ``n`` (the reference's ring model; 0 for n <= 1)."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * size
    if kind == "all-gather":
        return (n - 1) / n * size
    if kind == "reduce-scatter":
        return float(n - 1) * size
    if kind == "all-to-all":
        return (n - 1) / n * size
    if kind == "collective-permute":
        return float(size)
    raise ValueError(f"unknown collective kind {kind!r}")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _group_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


class CostCounter(TorchDispatchMode):
    """Count the FLOPs, bytes and collectives of the operations run inside
    ``with CostCounter() as c:``.  ``device_type`` (e.g. ``"cuda"``,
    ``"meta"``) restricts the count to operations on that device type (a
    host-side operation inside a card step, such as a random-state copy,
    is then not counted); None counts every device."""

    def __init__(self, device_type: Optional[str] = None):
        super().__init__()
        self.device_type = device_type
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, Dict[str, float]] = {}

    def __enter__(self):
        _build.cost_counters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _build.cost_counters.remove(self)
        return super().__exit__(*exc)

    def add(self, flops: float, nbytes: float) -> None:
        """A kernel's reckoned cost (``kernels._build.report_cost``)."""
        self.flops += flops
        self.bytes += nbytes

    def result(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": {k: dict(v) for k, v in
                                self.collectives.items()},
                "collective_wire_bytes": sum(
                    d["wire_bytes"] for d in self.collectives.values())}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs its local ops under us
        out = func(*args, **kwargs)
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out  # DTensor's shape propagation, not the program
        if self.device_type is not None:
            dev = (ins or outs or [None])[0]
            if dev is None or dev.device.type != self.device_type:
                return out
        self._count(func, args, kwargs, ins, outs)
        return out

    def _count(self, func, args, kwargs, ins, outs) -> None:
        packet = func._overloadpacket
        ns = func.namespace
        name = packet.__name__
        if ns in ("_c10d_functional", "_dtensor", "c10d_functional"):
            if name in _WAITS:
                return
            if name not in _COLLECTIVES:
                raise NotImplementedError(
                    f"CostCounter: no ring model for collective {func}")
            kind, which = _COLLECTIVES[name]
            size = sum(_nbytes(t) for t in (outs if which == "out" else
                                            ins[:1]))
            group = args[-1]
            n = _group_size(group)
            d = self.collectives.setdefault(kind, {"count": 0,
                                                   "wire_bytes": 0.0})
            d["count"] += 1
            d["wire_bytes"] += ring_wire_bytes(kind, size, n)
            self.bytes += sum(_nbytes(t) for t in ins + outs)
            return
        if packet in flop_registry:
            self.flops += flop_registry[packet](
                *args, **kwargs, out_val=outs[0] if len(outs) == 1 else outs)
        if func.is_view or packet in _FREE:
            return
        if packet in _GATHERS:
            self.bytes += 2 * sum(_nbytes(t) for t in outs)
            return
        if packet in _SCATTERS:
            upd = args[_SCATTERS[packet]]
            # a scalar scattered writes one element per index
            self.bytes += 2 * (_nbytes(upd) if isinstance(upd, torch.Tensor)
                               else args[2].numel() * args[0].element_size())
            return
        seen = {id(t) for t in ins}
        self.bytes += sum(_nbytes(t) for t in ins) + sum(
            _nbytes(t) for t in outs if id(t) not in seen)


def analyze(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a :class:`CostCounter`; returns
    (its result dict, ``fn``'s output)."""
    with CostCounter() as c:
        out = fn(*args, **kwargs)
    return c.result(), out
