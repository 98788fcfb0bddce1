"""Multi-pod dry run: trace every (arch x shape x mesh) cell on meta shards.

The counterpart of ``repro/launch/dryrun.py``.  For each cell it sets up a
fake process group of 256 or 512 ranks (``torch.distributed``'s ``fake``
backend: no device, no communication), builds the production mesh
(``launch/mesh.py``), places parameters, optimizer state, cache and batch
as ``DTensor``s whose local shards live on the meta device (placed by
``launch/sharding.py``; nothing is allocated on any device), registers the
activation rules for ``models.common.logical`` and runs the port's own
step -- ``train.make_train_step``, ``serve.prefill_step`` (after
``lm.encode_frames`` for audio) or ``lm.decode_step(backend="cuda")`` --
under the per-chip cost counter (``launch/hlo_cost.py``).  It records:

  - flops_per_chip, bytes_per_chip: rank 0's local program
  - collectives, collective_wire_bytes_per_chip: per kind, ring model
  - memory_analysis: argument and output bytes of rank 0's local shards
  - replication: flops_per_chip x chips over the FLOPs of the same step
    traced with no mesh (1 where every chip does its own share)

``DTensor`` propagates layouts to spend the least communication, compute
counted as free.  Beside the reference's constraint sites the port pins
the residual stream and its gradient after every sublayer and runs the
attention core on each chip's heads (or queries, the rules' ``queries``
axis, where the heads do not divide the model axis), so a train or
prefill step's products stay split.  A decode cell still repeats K4 and
the tied unembedding over the model axis where the kv heads or the
table's rows do not divide it (``replication`` near 10): its per-chip
FLOPs are what this program runs on a chip, not a chip's share.

The reference's XLA-only keys (``xla_flops_body_once``,
``xla_bytes_body_once``, ``compile_s``) have no counterpart: nothing is
compiled.  In place of its ``<tag>.hlo.zst``, an ``ok`` cell writes
``<tag>.ops.jsonl.gz`` beside ``<tag>.json``: every trace's counted
operations (the probes and the traces with no mesh), from which
``python -m repro_torch.launch.reanalyze DIR`` counts the record's FLOPs,
bytes, collectives and ``replication`` again after a change to the
counter's rules, without tracing.

With ``cfg.scan_layers`` (the default) a cell traces each stage's pattern
at one and two repeats (and a train step at two and three microbatches)
and extrapolates linearly to the full counts, exactly, since every repeat
and every microbatch after the first runs the same operations at the same
shapes -- the port's counterpart of the reference's HLO trip counts.
``scan_layers=False`` traces every layer.  A failure is the record's
``"fail"`` with the error (and its traceback), and the exit code is 1.

Where ``DTensor`` lacks a rule or refuses a layout, the trace adds an
explicit, counted redistribution: a ``view`` that splits a dim sharded
over more shards than it has heads (``_lenient_views``), ``flip`` and
``index_add`` rules (``_missing_rules``), the embedding's table whole
(``models/layers.py:embed``), the MoE's scatter and gather batch-local
(``models/common.py:batch_local``), the SSM and RWKV chunk loops' and
the train step's microbatch layouts (``logical``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b \\
      --shape train_4k --mesh both --out artifacts/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import time
import traceback
from fractions import Fraction
from typing import Any, Dict, List, Tuple

import torch

from ..configs import ALIASES, ARCHS, LONG_CONTEXT_OK, SHAPES, ShapeSpec, \
    get_config
from ..models.common import ModelConfig, set_sharding_rules
from . import sharding as shd
from .hlo_cost import CostCounter
from .mesh import batch_axes, make_production_mesh

__all__ = ["input_specs", "count_cell", "build_cell", "run_cell", "OpLog",
           "main"]


# ----------------------------------------------------------------- input specs

def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Meta tensors standing in for every model input of this cell (token
    ids in int64, the port's; image embeddings in ``cfg.dtype``; audio
    frames in float32)."""
    B, S = shape.global_batch, shape.seq_len
    i64 = torch.int64
    if shape.kind == "train":
        specs = {"tokens": (B, S), "labels": (B, S)}
    elif shape.kind == "prefill":
        specs = {"tokens": (B, S)}
    else:  # decode: one new token against a cache of length S
        specs = {"tokens": (B, 1)}
    out = {k: torch.empty(v, dtype=i64, device="meta")
           for k, v in specs.items()}
    if cfg.family == "vlm" and shape.kind != "decode":
        out["memory"] = torch.empty((B, cfg.num_image_tokens, cfg.d_model),
                                    dtype=cfg.dtype, device="meta")
    if cfg.family == "audio" and shape.kind != "decode":
        out["frames"] = torch.empty((B, cfg.encoder_seq, cfg.d_model),
                                    dtype=torch.float32, device="meta")
    return out


def _memory_len(cfg: ModelConfig) -> int:
    if cfg.family == "vlm":
        return cfg.num_image_tokens
    if cfg.family == "audio":
        return cfg.encoder_seq
    return 0


# ------------------------------------------------------------ process group

def _lenient_views() -> None:
    """Let ``view`` redistribute a ``DTensor`` whose sharded dim does not
    split evenly (a flat head dim sharded 16 ways over fewer than 16
    heads: 8 kv heads of granite-3-8b), as ``reshape`` may, instead of
    refusing.  The redistribution is an all-gather along that dim, counted
    like every other collective.  ``DTensor`` registers ``view`` strict
    only so that a view stays a view; the traced steps write through no
    view of a reshaped tensor."""
    from torch.distributed.tensor._ops._view_ops import \
        register_op_strategy_map
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    aten = torch.ops.aten
    for op in (aten.view.default, aten._unsafe_view.default):
        register_op_strategy_map(op, torch.Tensor.view,
                                 schema_info=RuntimeSchemaInfo(1),
                                 strict_view=False)
    _missing_rules()


def _missing_rules() -> None:
    """Sharding rules for two operations ``DTensor`` has none for in some
    torch releases: ``flip`` (a cumsum's gradient flips) and ``index_add``
    (an ``index_select``'s gradient).  A dim that is flipped or indexed is
    replicated first; the others may stay sharded, alike on every operand
    of the same shape."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten
    prop = DTensor._op_dispatcher.sharding_propagator

    def missing(op):
        return not any(op in getattr(prop, table, {}) for table in (
            "op_strategy_funcs", "op_single_dim_strategy_funcs",
            "op_to_rules"))

    if missing(aten.flip.default):
        @register_sharding(aten.flip.default)
        def flip(x, dims):
            flipped = {d % x.ndim for d in dims}
            return [([Replicate()], [Replicate(), None])] + [
                ([Shard(d)], [Shard(d), None]) for d in range(x.ndim)
                if d not in flipped]

    if missing(aten.index_add.default):
        @register_sharding(aten.index_add.default)
        def index_add(x, dim, index, source, alpha=1):
            dim %= x.ndim
            return [([Replicate()], [Replicate(), None, Replicate(),
                                     Replicate()])] + [
                ([Shard(d)], [Shard(d), None, Replicate(), Shard(d)])
                for d in range(x.ndim) if d != dim]


def _fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0 (its
    local shards are rank 0's).  An existing group of another size is
    replaced; one of this size is kept."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    _lenient_views()


# --------------------------------------------------------------- placement

def _local_shape(shape, placements, mesh) -> Tuple[int, ...]:
    """Rank 0's shard: ``torch.chunk``'s first piece along each sharded
    dim (the whole dim where it divides evenly)."""
    out = list(shape)
    for d, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] = -(-out[p.dim] // mesh.size(d))
    return tuple(out)


def _meta_dtensor(t: torch.Tensor, placements, mesh):
    from torch.distributed.tensor import DTensor
    local = torch.empty(_local_shape(t.shape, placements, mesh),
                        dtype=t.dtype, device="meta")
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def _distribute(tree, specs, mesh):
    """The meta tensors of ``tree`` as meta ``DTensor``s placed by
    ``specs`` (a tree of :class:`sharding.P` of the same structure);
    non-tensor leaves (cache lengths) stay."""
    if isinstance(tree, torch.Tensor):
        return _meta_dtensor(tree, shd.to_placements(specs, mesh), mesh)
    if isinstance(tree, dict):
        return {k: _distribute(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_distribute(v, s, mesh) for v, s in zip(tree, specs)]
        if isinstance(tree, list):
            return items
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return tree


def _local_bytes(tree) -> int:
    """Bytes of the local shards (of plain tensors: the tensors) in a
    tree."""
    from ..tree import tree_leaves
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            local = t.to_local() if hasattr(t, "to_local") else t
            total += local.numel() * local.element_size()
    return total


# ------------------------------------------------------------------ tracing

def _trace(cfg: ModelConfig, shape: ShapeSpec, mesh, baxes, batch: int,
           microbatches: int, log=None) -> Dict[str, Any]:
    """Run one cell's step on meta shards of ``cfg`` (at global batch
    ``batch``) under the cost counter; returns its counts and the local
    bytes of its arguments and outputs.  With ``mesh`` None, the whole
    step on plain meta tensors.  ``log``: a list that gets the counted
    events (``hlo_cost.op_event``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from ..models import lm
    from ..serve import prefill_step
    from ..train import init_train_state, make_train_step

    def place(tree, specs):  # specs(tree) -> its specs on the mesh
        return tree if mesh is None else _distribute(tree, specs(tree), mesh)

    shape = ShapeSpec(shape.name, shape.seq_len, batch, shape.kind)
    inputs = place(input_specs(cfg, shape),
                   lambda t: shd.batch_specs(t, mesh, baxes))
    if shape.kind == "train":
        state = place(init_train_state(cfg, device="meta"),
                      lambda t: shd.state_specs(t, cfg, mesh))
        step = make_train_step(cfg, lr=1e-4, microbatches=microbatches)
        args = (state, inputs)
    elif shape.kind == "prefill":
        params = place(lm.init_params(cfg, device="meta"),
                       lambda t: shd.param_specs(t, cfg, mesh))

        def step(params, inputs):
            memory = inputs.get("memory")
            if cfg.family == "audio":
                memory = lm.encode_frames(params, inputs["frames"], cfg)
            return prefill_step(params, inputs["tokens"], cfg, memory)
        args = (params, inputs)
    else:
        params = place(lm.init_params(cfg, device="meta"),
                       lambda t: shd.param_specs(t, cfg, mesh))
        cache = place(lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                                    _memory_len(cfg), device="meta"),
                      lambda t: shd.cache_specs(t, cfg, mesh, baxes,
                                                shape.global_batch == 1))

        def step(params, cache, inputs):
            return lm.decode_step(params, cache, inputs["tokens"], cfg,
                                  backend="cuda")
        args = (params, cache, inputs)
    arg_bytes = _local_bytes(args)
    set_sharding_rules(None if mesh is None
                       else shd.activation_rules(cfg, mesh, baxes))
    try:
        with implicit_replication(), CostCounter(log=log) as counter:
            out = step(*args)
    finally:
        set_sharding_rules(None)
    res = counter.result()
    res["argument_size_in_bytes"] = arg_bytes
    res["output_size_in_bytes"] = _local_bytes(out)
    return res


def _plan(cfg: ModelConfig):
    """(the stage patterns, the repeat counts) of ``cfg``: each stage of
    ``lm.stage_plan`` and, for the encoder-decoder, the encoder's layers."""
    from ..models.lm import stage_plan
    plan = stage_plan(cfg)
    reps = [r for _, r in plan]
    if cfg.encoder_layers:
        reps.append(cfg.encoder_layers)
    return [p for p, _ in plan], reps


def _probes(cfg: ModelConfig) -> List[Tuple[Tuple[int, ...], ModelConfig]]:
    """Configs of the same stage patterns at few repeats whose repeat
    vectors, with a constant, span the full one (k stages: k + 1 probes,
    the smallest first)."""
    import numpy as np
    pats, full = _plan(cfg)
    k = len(full)
    found: Dict[Tuple[int, ...], ModelConfig] = {}
    enc = (1, 2) if cfg.encoder_layers else (None,)
    for L in range(1, cfg.num_layers + 1):
        for E in enc:
            c = cfg.replace(num_layers=L) if E is None \
                else cfg.replace(num_layers=L, encoder_layers=E)
            p, v = _plan(c)
            if p == pats and all(x <= y for x, y in zip(v, full)):
                found.setdefault(tuple(v), c)
        pick: List[Tuple[int, ...]] = []
        for v in sorted(found, key=sum):
            rows = [(1,) + u for u in pick + [v]]
            if np.linalg.matrix_rank(np.array(rows)) == len(rows):
                pick.append(v)
        if len(pick) == k + 1:
            return [(v, found[v]) for v in pick]
    return [(tuple(full), cfg)]


def _solve(rows: List[Tuple[int, ...]], vals: List[Fraction],
           at: Tuple[int, ...]) -> Fraction:
    """The affine function through (rows[i], vals[i]) evaluated at ``at``,
    in exact arithmetic (Gaussian elimination over fractions)."""
    n = len(rows)
    m = [[Fraction(1)] + [Fraction(x) for x in r] + [v]
         for r, v in zip(rows, vals)]
    for c in range(n):
        piv = next(i for i in range(c, n) if m[i][c] != 0)
        m[c], m[piv] = m[piv], m[c]
        for i in range(n):
            if i != c and m[i][c] != 0:
                f = m[i][c] / m[c][c]
                m[i] = [a - f * b for a, b in zip(m[i], m[c])]
    coef = [m[i][n] / m[i][i] for i in range(n)]
    return sum(a * x for a, x in zip(coef, (1,) + tuple(at)))


def _flat(res: Dict[str, Any]) -> Dict[str, Fraction]:
    """A trace's counts as one flat dict of exact numbers."""
    out = {"flops": Fraction(res["flops"]), "bytes": Fraction(res["bytes"]),
           "argument_size_in_bytes": Fraction(res["argument_size_in_bytes"]),
           "output_size_in_bytes": Fraction(res["output_size_in_bytes"])}
    for kind, d in res["collectives"].items():
        out[f"{kind}.count"] = Fraction(d["count"])
        out[f"{kind}.wire_bytes"] = Fraction(d["wire_bytes"])
    return out


def _combine(points: List[Tuple[Tuple[int, ...], Dict[str, Fraction]]],
             at: Tuple[int, ...]) -> Dict[str, Fraction]:
    keys = sorted({k for _, d in points for k in d})
    if len(points) == 1:
        return {k: points[0][1].get(k, Fraction(0)) for k in keys}
    rows = [v for v, _ in points]
    return {k: _solve(rows, [d.get(k, Fraction(0)) for _, d in points], at)
            for k in keys}


def _plan_cell(cfg: ModelConfig, shape: ShapeSpec,
               microbatches: int = 0) -> Dict[str, Any]:
    """What :func:`count_cell` traces: the full repeat vector, the
    microbatches of the step, the microbatch counts traced, the traced
    configs (repeat vector, config) and the microbatch size."""
    mb = 1
    if shape.kind == "train":
        mb = microbatches or cfg.train_microbatches
        while shape.global_batch % mb or (shape.global_batch // mb) < 1:
            mb //= 2
    _, full = _plan(cfg)
    if not cfg.scan_layers:
        return {"full": tuple(full), "mb": mb, "m_counts": (mb,),
                "probes": [(tuple(full), cfg)], "size": shape.global_batch
                // mb}
    # one microbatch differs from several (the batch is laid out for the
    # microbatches only when there are some): extrapolate from 2 and 3
    return {"full": tuple(full), "mb": mb,
            "m_counts": (2, 3) if shape.kind == "train" and mb > 3 else (mb,),
            "probes": _probes(cfg), "size": shape.global_batch // mb}


def _extrapolate(traces: List[Tuple[Tuple[int, ...], int,
                                    Dict[str, Fraction]]],
                 full: Tuple[int, ...], mb: int) -> Dict[str, Any]:
    """The full step's counts from its traces (repeat vector, microbatch
    count, flat counts): affine in the repeats at each microbatch count,
    then c(m) = c(2) + (m - 2) * (c(3) - c(2)) where two were traced."""
    per_m: Dict[int, Dict[str, Fraction]] = {}
    for m in dict.fromkeys(m for _, m, _ in traces):
        per_m[m] = _combine([(v, f) for v, mm, f in traces if mm == m],
                            full)
    if len(per_m) == 1:
        return _unflat(next(iter(per_m.values())))
    two, three = per_m[2], per_m[3]
    z = Fraction(0)
    return _unflat({k: two.get(k, z) + (mb - 2) * (three.get(k, z)
                                                  - two.get(k, z))
                    for k in set(two) | set(three)})


def count_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, baxes,
               microbatches: int = 0, log=None) -> Dict[str, Any]:
    """The per-chip counts of one cell (with ``mesh`` None, of the whole
    step): with ``cfg.scan_layers``, traced at the :func:`_probes` (and,
    for a train step of more than 3 microbatches, at 2 and 3 microbatches
    of the full step's microbatch size) and extrapolated; otherwise traced
    whole.  ``log`` (anything with ``append``, e.g. :class:`OpLog`) gets
    each trace's events, then a line that closes them, ``{"trace":
    {"mesh", "repeats", "microbatches", "full", "mb", argument and output
    bytes}}`` -- what ``launch/reanalyze.py`` counts again."""
    plan = _plan_cell(cfg, shape, microbatches)
    traces = []
    for m in plan["m_counts"]:
        for v, c in plan["probes"]:
            res = _trace(c, shape, mesh, baxes, plan["size"] * m, m, log)
            traces.append((v, m, _flat(res)))
            if log is not None:
                log.append({"trace": {
                    "mesh": mesh is not None, "repeats": list(v),
                    "microbatches": m, "full": list(plan["full"]),
                    "mb": plan["mb"],
                    "argument_size_in_bytes": res["argument_size_in_bytes"],
                    "output_size_in_bytes": res["output_size_in_bytes"]}})
    return _extrapolate(traces, plan["full"], plan["mb"])


def _unflat(flat: Dict[str, Fraction]) -> Dict[str, Any]:
    bad = sorted(k for k, v in flat.items() if v < 0)
    if bad:  # a count that is not linear in the repeats
        raise ValueError(f"extrapolated counts below 0: {bad}; trace the "
                         f"cell whole (scan_layers=False)")
    coll: Dict[str, Dict[str, float]] = {}
    for k, v in flat.items():
        if "." in k:
            kind, what = k.split(".")
            d = coll.setdefault(kind, {})
            d[what] = int(v) if what == "count" else float(v)
    coll = {k: d for k, d in coll.items() if d.get("count")}
    return {"flops": float(flat["flops"]), "bytes": float(flat["bytes"]),
            "collectives": coll,
            "collective_wire_bytes": sum(d["wire_bytes"]
                                         for d in coll.values()),
            "argument_size_in_bytes": int(flat["argument_size_in_bytes"]),
            "output_size_in_bytes": int(flat["output_size_in_bytes"])}


# ---------------------------------------------------------------------- cells

def build_cell(arch: str, shape_name: str, multi_pod: bool,
               microbatches: int = 0, cfg_override=None,
               smoke: bool = False, log=None) -> Tuple[Dict[str, Any], dict]:
    """(the cell's counts, its metadata) for one cell.  ``smoke=True``
    swaps in the reduced config (same family and stage plan) -- CI's check
    of the whole path on the production mesh.  ``log``: gets the traces'
    events and closing lines (:func:`count_cell`), the mesh's first, then
    those with no mesh."""
    cfg = cfg_override or get_config(arch, smoke=smoke)
    shape = SHAPES[shape_name]
    _fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    counts = count_cell(cfg, shape, mesh, batch_axes(multi_pod),
                        microbatches, log)
    chips = 512 if multi_pod else 256
    whole = count_cell(cfg, shape, None, None, microbatches, log)["flops"]
    counts["replication"] = counts["flops"] * chips / whole
    meta = {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16",
            "kind": shape.kind, "n_params": cfg.param_count(),
            "n_active": cfg.active_param_count(),
            "chips": chips,
            "global_batch": shape.global_batch, "seq_len": shape.seq_len}
    return counts, meta


class OpLog:
    """A cell's traces (:func:`count_cell`'s ``log``) written as gzip'd
    JSON lines as they come, so a train cell's millions of events never
    sit in memory (stdlib ``gzip``: ``zstandard`` may be missing where the
    dry run runs); ``launch/reanalyze.py`` counts them again."""

    def __init__(self, path: str):
        self._f = gzip.open(path, "wt", compresslevel=6)

    def append(self, line: dict) -> None:
        self._f.write(json.dumps(line, separators=(",", ":")) + "\n")

    def close(self) -> None:
        self._f.close()


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             microbatches: int = 0, smoke: bool = False) -> dict:
    t0 = time.time()
    tag = f"{arch}_{shape_name}_{'multi' if multi_pod else 'single'}"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, tag + ".ops.jsonl.gz")
    log = OpLog(path + ".part")
    try:
        counts, rec = build_cell(arch, shape_name, multi_pod, microbatches,
                                 smoke=smoke, log=log)
        rec["flops_per_chip"] = counts["flops"]
        rec["bytes_per_chip"] = counts["bytes"]
        rec["collectives"] = counts["collectives"]
        rec["collective_wire_bytes_per_chip"] = \
            counts["collective_wire_bytes"]
        rec["replication"] = counts["replication"]
        rec["memory_analysis"] = {
            "argument_size_in_bytes": counts["argument_size_in_bytes"],
            "output_size_in_bytes": counts["output_size_in_bytes"]}
        rec["trace_s"] = time.time() - t0
        rec["status"] = "ok"
    except Exception as e:  # the record carries the failure
        rec = {"arch": arch, "shape": shape_name,
               "mesh": "2x16x16" if multi_pod else "16x16",
               "status": "fail", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc(limit=-12)}
    finally:
        log.close()
    if rec["status"] == "ok":
        os.replace(path + ".part", path)
    else:
        os.remove(path + ".part")
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[{rec['status']}] {tag} (trace {rec.get('trace_s', 0):.1f}s) "
          f"{rec.get('error', '')}", flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="0 = use cfg.train_microbatches")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs on the production mesh (CI)")
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or not args.arch) \
        else [ALIASES.get(args.arch, args.arch)]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
                print(f"[skip] {arch}_{shape} (full attention)", flush=True)
                continue
            for mp in meshes:
                rec = run_cell(arch, shape, mp, args.out,
                               args.microbatches, smoke=args.smoke)
                n_fail += rec["status"] != "ok"
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
