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

Each counted operation becomes an event (:func:`op_event`: plain JSON
data) and :func:`event_cost` turns an event into its counts; the counter
and ``launch/reanalyze.py`` (which counts a dry run's saved events again)
share that one function.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels import _build

__all__ = ["CostCounter", "Tally", "op_event", "event_cost",
           "ring_wire_bytes", "analyze"]

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
_COLL_NS = ("_c10d_functional", "_dtensor", "c10d_functional")


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


def _group_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


# ------------------------------------------------------------------ events
# An event is one counted operation as plain JSON-able data: the op's name;
# its arguments with each tensor replaced by {"t": shape, "d": dtype};
# its tensor outputs the same way, each flagged when it is one of the
# inputs (an in-place result); a collective's group size; or a kernel's
# reckoned cost ({"op": "report_cost", "flops", "bytes"}).  ``event_cost``
# turns one into counts: the trace and ``launch/reanalyze.py`` share it.

def _enc(a):
    if isinstance(a, torch.Tensor):
        return {"t": list(a.shape), "d": str(a.dtype).replace("torch.", "")}
    if isinstance(a, (list, tuple)):
        return [_enc(x) for x in a]
    if isinstance(a, dict):
        return {k: _enc(v) for k, v in a.items()}
    if a is None or isinstance(a, (bool, int, float, str)):
        return a
    return repr(a)  # a dtype, device or layout: no rule reads it


def _is_t(a) -> bool:
    return isinstance(a, dict) and "t" in a and "d" in a


def _tensors(a) -> list:
    if _is_t(a):
        return [a]
    if isinstance(a, list):
        return [t for x in a for t in _tensors(x)]
    if isinstance(a, dict):
        return [t for x in a.values() for t in _tensors(x)]
    return []


def _shapes(a):
    """Tensors as their shapes, the arguments of a FLOP formula."""
    if _is_t(a):
        return torch.Size(a["t"])
    if isinstance(a, list):
        return [_shapes(x) for x in a]
    if isinstance(a, dict):
        return {k: _shapes(v) for k, v in a.items()}
    return a


def _numel(t) -> int:
    n = 1
    for d in t["t"]:
        n *= d
    return n


def _itemsize(t) -> int:
    return getattr(torch, t["d"]).itemsize


def _nbytes(t) -> int:
    return _numel(t) * _itemsize(t)


def op_event(func, args, kwargs, outs) -> dict:
    """The event of one aten operation on plain tensors."""
    ins = {id(a) for a in tree_flatten((args, kwargs))[0]
           if isinstance(a, torch.Tensor)}
    ev = {"op": str(func), "args": _enc(list(args)),
          "kwargs": _enc(dict(kwargs)), "outs": _enc(outs),
          "alias": [id(o) in ins for o in outs]}
    if func.namespace in _COLL_NS and func._overloadpacket.__name__ in \
            _COLLECTIVES:
        ev["group"] = _group_size(args[-1])
    return ev



def _func(name: str):
    ns, op, overload = name.split(".")
    return getattr(getattr(getattr(torch.ops, ns), op), overload)


def event_cost(ev: dict) -> dict:
    """An event's counts: ``flops``, ``bytes`` and, for a collective,
    ``collective`` = (kind, wire bytes a chip sends under the ring
    model)."""
    if ev["op"] == "report_cost":
        return {"flops": ev["flops"], "bytes": ev["bytes"]}
    ns, name, _ = ev["op"].split(".")
    args, kwargs, outs = ev["args"], ev["kwargs"], ev["outs"]
    ins = _tensors([args, kwargs])
    if ns in _COLL_NS:
        if name in _WAITS:
            return {"flops": 0, "bytes": 0}
        if name not in _COLLECTIVES:
            raise NotImplementedError(
                f"CostCounter: no ring model for collective {ev['op']}")
        kind, which = _COLLECTIVES[name]
        size = sum(_nbytes(t) for t in (outs if which == "out" else ins[:1]))
        return {"flops": 0,
                "bytes": sum(_nbytes(t) for t in ins + outs),
                "collective": (kind, ring_wire_bytes(kind, size,
                                                     ev["group"]))}
    func = _func(ev["op"])
    packet = func._overloadpacket
    flops = 0
    if packet in flop_registry:
        o = _shapes(outs)
        flops = flop_registry[packet](*_shapes(args), **_shapes(kwargs),
                                      out_val=o[0] if len(o) == 1 else o)
    if func.is_view or packet in _FREE:
        return {"flops": flops, "bytes": 0}
    if packet in _GATHERS:
        return {"flops": flops, "bytes": 2 * sum(_nbytes(t) for t in outs)}
    if packet in _SCATTERS:
        upd = args[_SCATTERS[packet]]
        # a scalar scattered writes one element per index
        return {"flops": flops,
                "bytes": 2 * (_nbytes(upd) if _is_t(upd) else
                              _numel(args[2]) * _itemsize(args[0]))}
    return {"flops": flops,
            "bytes": sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t, a in zip(outs, ev["alias"]) if not a)}


class Tally:
    """Counts summed over events, in their order: ``flops``, ``bytes``
    and ``collectives`` (kind -> count, wire bytes)."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, Dict[str, float]] = {}

    def add_event(self, ev: dict) -> None:
        c = event_cost(ev)
        self.flops += c["flops"]
        self.bytes += c["bytes"]
        if "collective" in c:
            kind, wire = c["collective"]
            d = self.collectives.setdefault(kind, {"count": 0,
                                                   "wire_bytes": 0.0})
            d["count"] += 1
            d["wire_bytes"] += wire

    def result(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": {k: dict(v) for k, v in
                                self.collectives.items()},
                "collective_wire_bytes": sum(
                    d["wire_bytes"] for d in self.collectives.values())}


class CostCounter(TorchDispatchMode):
    """Count the FLOPs, bytes and collectives of the operations run inside
    ``with CostCounter() as c:``.  ``device_type`` (e.g. ``"cuda"``,
    ``"meta"``) restricts the count to operations on that device type (a
    host-side operation inside a card step, such as a random-state copy,
    is then not counted); None counts every device.  ``log``: a list that
    gets every counted event (``op_event``), in order."""

    def __init__(self, device_type: Optional[str] = None,
                 log: Optional[list] = None):
        super().__init__()
        self.device_type = device_type
        self.log = log
        self.tally = Tally()

    flops = property(lambda self: self.tally.flops)
    bytes = property(lambda self: self.tally.bytes)
    collectives = property(lambda self: self.tally.collectives)

    def __enter__(self):
        _build.cost_counters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _build.cost_counters.remove(self)
        return super().__exit__(*exc)

    def add(self, flops: float, nbytes: float) -> None:
        """A kernel's reckoned cost (``kernels._build.report_cost``)."""
        self._record({"op": "report_cost", "flops": flops, "bytes": nbytes})

    def result(self) -> dict:
        return self.tally.result()

    def _record(self, ev: dict) -> None:
        self.tally.add_event(ev)
        if self.log is not None:
            self.log.append(ev)

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
        self._record(op_event(func, args, kwargs, outs))
        return out


def analyze(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a :class:`CostCounter`; returns
    (its result dict, ``fn``'s output)."""
    with CostCounter() as c:
        out = fn(*args, **kwargs)
    return c.result(), out
