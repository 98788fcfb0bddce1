"""The port's sharding policy against the reference's, and the layouts it
gives ``DTensor``s.

Spec parity: ``param_specs``, ``state_specs``, ``batch_specs`` and
``cache_specs`` of the port (``repro_torch.launch.sharding``) equal the
reference's (``repro.launch.sharding``) for all ten FULL configs on the
(16, 16) and (2, 16, 16) meshes, entry for entry.  The reference runs on an
``AbstractMesh`` over abstract trees (no devices), the port on a mapping of
axis sizes over meta tensors.  The reference's stacked leaves carry a
leading scan dim whose spec is None; each of the port's per-layer leaves
gets the reference's stage spec without it.

The ``DTensor`` layouts run in subprocesses, each owning its process
group: ``place_on_mesh`` on a one-rank mesh, and K4's local-shard call and
the sequence-sharded decode's two all-reduces on four ``gloo`` ranks,
against the plain decode core within 1e-5.
"""
import functools
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import init_train_state as jax_init_state  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs import idealem_paper  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import (get_sharding_rules,  # noqa: E402
                                       logical, set_sharding_rules)
from repro_torch.train import init_train_state  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
MESHES = {"single": ((16, 16), ("data", "model"), ("data",)),
          "multi": ((2, 16, 16), ("pod", "data", "model"), ("pod", "data"))}


@functools.lru_cache(maxsize=None)
def _jax_trees(arch):
    """The reference's abstract parameter and train-state trees of a FULL
    config (shared by the two meshes' cases)."""
    jcfg = jax_config(arch)
    key = jax.random.key(0)
    return (jax.eval_shape(lambda k: jlm.init_params(k, jcfg), key),
            jax.eval_shape(lambda k: jax_init_state(k, jcfg), key))


def _meshes(name):
    shape, axes, baxes = MESHES[name]
    return AbstractMesh(shape, axes), dict(zip(axes, shape)), baxes


def _flat_ref(tree):
    """Reference spec leaves in ``jax.tree`` order, as tuples."""
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))]


def _unstack(spec):
    return PartitionSpec(*tuple(spec)[1:])


def _ref_layers(stages, cfg):
    """The reference's per-stage (stacked) tree mapped onto the port's
    per-layer list, leading scan dims dropped from every spec."""
    layers = []
    for stage, (pattern, reps) in zip(stages, jlm.stage_plan(cfg)):
        for _ in range(reps):
            for i in range(len(pattern)):
                layers.append(jax.tree.map(
                    _unstack, stage.get(f"p{i}", {}),
                    is_leaf=lambda x: isinstance(x, PartitionSpec)))
    return layers


def _ref_params_per_layer(spec, cfg):
    out = {"embed": spec["embed"], "final_norm": spec["final_norm"],
           "layers": _ref_layers(spec["stages"], cfg)}
    if "shared" in spec:
        out["shared"] = spec["shared"]
    if "encoder" in spec:
        one = jax.tree.map(_unstack, spec["encoder"]["stage"]["p0"],
                           is_leaf=lambda x: isinstance(x, PartitionSpec))
        out["encoder"] = {"layers": [one] * cfg.encoder_layers,
                          "norm": spec["encoder"]["norm"]}
    return out


def _flat_port(tree):
    return [tuple(s) for s in _spec_leaves(tree)]


def _spec_leaves(tree):
    """The port's spec leaves (``P``) in ``jax.tree`` order (dict keys
    sorted, None holding nothing)."""
    if tree is None:
        return []
    if isinstance(tree, shd.P):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    return [x for v in tree for x in _spec_leaves(v)]


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_specs_equal_reference(arch, mesh):
    assert ARCHS == JAX_ARCHS
    amesh, sizes, _ = _meshes(mesh)
    jcfg, cfg = jax_config(arch), get_config(arch)
    jparams, jstate = _jax_trees(arch)
    want = _ref_params_per_layer(jshd.param_specs(jparams, jcfg, amesh),
                                 jcfg)
    got = shd.param_specs(lm.init_params(cfg, device="meta"), cfg, sizes)
    assert _flat_port(got) == _flat_ref(want)

    jspec = jshd.state_specs(jstate, jcfg, amesh)
    want = [jspec.opt.step] + [
        _ref_params_per_layer(t, jcfg) for t in (jspec.opt.mu,
                                                 jspec.opt.nu)]
    state = init_train_state(cfg, device="meta")
    spec = shd.state_specs(state, cfg, sizes)
    assert spec.gradcomp is None and jspec.gradcomp is None
    assert _flat_port([spec.opt.step, spec.opt.mu, spec.opt.nu]) \
        == _flat_ref(want)
    assert _flat_port(spec.params) == _flat_port(got)


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_equal_reference(arch, mesh):
    amesh, sizes, baxes = _meshes(mesh)
    jcfg, cfg = jax_config(arch), get_config(arch)
    M = {"vlm": cfg.num_image_tokens,
         "audio": cfg.encoder_seq}.get(cfg.family, 0)
    for B, S, seq in ((128, 32_768, False), (1, 524_288, True)):
        jcache = jax.eval_shape(lambda: jlm.init_cache(jcfg, B, S, M))
        jspec = jshd.cache_specs(jcache, jcfg, amesh, baxes, seq)
        want = _ref_layers(jspec.stages, jcfg)
        cache = lm.init_cache(cfg, B, S, M, device="meta")
        spec = shd.cache_specs(cache, cfg, sizes, baxes, seq)
        assert len(spec.layers) == len(want)
        for got_l, want_l in zip(spec.layers, want):
            pairs = ([(got_l, want_l)] if not isinstance(got_l, dict)
                     else [(got_l[k], want_l[k]) for k in ("self", "cross")])
            for g, w in pairs:
                for field in g._fields:
                    if field == "length":  # a Python int in the port
                        assert getattr(g, field) is None
                        continue
                    assert tuple(getattr(g, field)) == tuple(
                        getattr(w, field)), (field, g, w)
        if M:
            assert tuple(spec.memory) == tuple(jspec.memory)
        else:
            assert spec.memory is None and jspec.memory is None

    for kind, (B, S) in (("train", (256, 4096)), ("decode", (128, 1))):
        jin = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
        tin = {"tokens": torch.empty((B, S), dtype=torch.int64,
                                     device="meta")}
        if kind == "train" and M:
            jin["memory"] = jax.ShapeDtypeStruct((B, M, cfg.d_model),
                                                 jnp.float32)
            tin["memory"] = torch.empty((B, M, cfg.d_model), device="meta")
        want = jshd.batch_specs(jin, amesh, baxes)
        got = shd.batch_specs(tin, sizes, baxes)
        assert {k: tuple(v) for k, v in got.items()} == {
            k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_activation_rules_equal_reference(mesh):
    amesh, sizes, baxes = _meshes(mesh)
    for arch in ARCHS:
        for ep in (False, True):
            jcfg = jax_config(arch).replace(moe_expert_parallel=ep)
            cfg = get_config(arch).replace(moe_expert_parallel=ep)
            rules = shd.activation_rules(cfg, sizes, baxes)
            # the port's own axis (models/attention.py:_attend): the
            # attention core's queries take the model axis exactly where
            # the heads do not; every other rule is the reference's
            assert rules.pop("queries") == (None if rules["heads"]
                                            else "model")
            assert rules == jshd.activation_rules(jcfg, amesh, baxes)
            if not cfg.num_experts:
                continue
            # expert-parallel leaves follow the switch as in the reference
            jp = _jax_trees(arch)[0]
            want = _ref_params_per_layer(
                jshd.param_specs(jp, jcfg, amesh), jcfg)
            got = shd.param_specs(lm.init_params(cfg, device="meta"), cfg,
                                  sizes)
            assert _flat_port(got) == _flat_ref(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_reference(arch):
    jcfg, cfg = jax_config(arch), get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


def test_new_config_fields_have_reference_defaults():
    jcfg, cfg = jax_config("granite_3_8b"), get_config("granite_3_8b")
    for f in ("moe_expert_parallel", "scan_layers", "train_microbatches"):
        assert getattr(cfg, f) == getattr(jcfg, f)


def test_shapes_and_cells_equal_reference():
    from repro.configs import LONG_CONTEXT_OK as JLONG
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import cells as jcells
    from repro_torch.configs import LONG_CONTEXT_OK, SHAPES, cells
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind)
            for k, v in SHAPES.items()} == {
        k: (v.name, v.seq_len, v.global_batch, v.kind)
        for k, v in JSHAPES.items()}
    assert LONG_CONTEXT_OK == JLONG
    assert cells() == jcells() and len(cells()) == 34
    assert cells("zamba2-1.2b") == jcells("zamba2-1.2b")


def test_logical_is_identity_without_rules():
    assert get_sharding_rules() is None
    x = torch.zeros(2, 3)
    assert logical(x, "batch", None) is x
    set_sharding_rules({"batch": ("data",)})
    try:  # a plain tensor has no mesh: returned as it is
        assert logical(x, "batch", None) is x
    finally:
        set_sharding_rules(None)


def test_idealem_paper_equals_reference():
    from repro.configs import idealem_paper as jpaper
    for name in ("MAG", "ANG_RESIDUAL", "ANG_DELTA"):
        assert getattr(idealem_paper, name) == getattr(jpaper, name)
    for tc, jc in ((idealem_paper.mag_codec(device="cpu"),
                    jpaper.mag_codec()),
                   (idealem_paper.ang_codec(device="cpu"),
                    jpaper.ang_codec()),
                   (idealem_paper.ang_codec(delta=True, device="cpu"),
                    jpaper.ang_codec(delta=True))):
        for f in ("mode", "block_size", "num_dict", "alpha", "rel_tol",
                  "value_range"):
            assert getattr(tc, f) == getattr(jc, f)
        assert float(tc.d_crit) == float(jc.d_crit)


def _run(code, timeout=240):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def test_place_on_mesh_one_rank(tmp_path):
    out = _run(f"""
import numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.data.pipeline import place_on_mesh
from repro_torch.launch.mesh import make_debug_mesh
dist.init_process_group("gloo", init_method="file://{tmp_path}/pg",
                        rank=0, world_size=1)
mesh = make_debug_mesh(1, 1)
batch = {{"tokens": np.arange(12).reshape(4, 3), "x": torch.ones(4, 2)}}
placed = place_on_mesh(mesh)(batch)
for k, v in placed.items():
    assert isinstance(v, DTensor), k
    assert tuple(v.placements) == (Shard(0), Replicate()), v.placements
np.testing.assert_array_equal(placed["tokens"].to_local().numpy(),
                              batch["tokens"])
from repro_torch.launch.sharding import P, to_shardings
got = to_shardings({{"a": P(("data",), None), "b": [None, P(None, "model")]}},
                   mesh)
assert got == {{"a": (Shard(0), Replicate()),
               "b": [None, (Replicate(), Shard(1))]}}, got
dist.destroy_process_group()
print("PLACED_OK")
""")
    assert "PLACED_OK" in out


WORKER = r"""
import os, sys, numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor.experimental import implicit_replication
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor
from repro_torch.kernels.flash_decode import flash_decode, \
    flash_decode_torch
from repro_torch.models.attention import KVCache, ring_valid, \
    decode_attention
from repro_torch.models.common import ModelConfig

rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="file://" + sys.argv[2],
                        rank=rank, world_size=4)
g = torch.Generator().manual_seed(0)
# K4 on local shards: batch over data (2), kv heads over model (2)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
B, H, Hkv, C, hd = 4, 8, 4, 24, 16
q = torch.randn(B, H, hd, generator=g)
k = torch.randn(B, C, Hkv, hd, generator=g)
v = torch.randn(B, C, Hkv, hd, generator=g)
valid = ring_valid(30, C, 20).expand(B, C)
want = flash_decode_torch(q, k, v, valid)
kp = (Shard(0), Shard(2))
got = flash_decode(distribute_tensor(q, mesh, (Replicate(), Replicate())),
                   distribute_tensor(k, mesh, kp),
                   distribute_tensor(v, mesh, kp), valid)
assert tuple(got.placements) == (Shard(0), Shard(1)), got.placements
err = (got.full_tensor() - want).abs().max().item()
assert err < 1e-5, err
# the sequence-sharded cache: positions over data (4), one batch row
mesh = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
cfg = ModelConfig(d_model=64, num_heads=4, num_kv_heads=2, dtype=torch.float32)
C, pos = 32, 21
kc = torch.randn(1, C, 2, 16, generator=g)
vc = torch.randn(1, C, 2, 16, generator=g)
x = torch.randn(1, 1, 64, generator=g)
p = {n: torch.randn(*s, generator=g) * 0.1 for n, s in
     (("wq", (64, 64)), ("wk", (64, 32)), ("wv", (64, 32)), ("wo", (64, 64)))}
for window in (None, 12):
    plain = KVCache(kc.clone(), vc.clone(), pos)
    want, wc = decode_attention(p, x, plain, cfg, window=window,
                                backend="torch")
    sp = (Shard(1), Replicate())
    dc = KVCache(distribute_tensor(kc.clone(), mesh, sp),
                 distribute_tensor(vc.clone(), mesh, sp), pos)
    rep = (Replicate(), Replicate())
    dp = {n: distribute_tensor(t, mesh, rep) for n, t in p.items()}
    with implicit_replication():  # the RoPE angles and ring mask
        got, gc = decode_attention(dp, distribute_tensor(x, mesh, rep), dc,
                                   cfg, window=window, backend="cuda")
    err = (got.full_tensor() - want).abs().max().item()
    assert err < 1e-5, (window, err)
    assert torch.equal(gc.k.full_tensor(), wc.k), "the new K"
    assert torch.equal(gc.v.full_tensor(), wc.v), "the new V"
    assert gc.length == pos + 1
dist.destroy_process_group()
print("RANK_OK", rank)
"""


def test_dtensor_decode_cores_on_four_ranks(tmp_path):
    """K4's local-shard call (batch and kv heads sharded) and the
    sequence-sharded decode (each rank's partial softmax merged by two
    all-reduces; the new K and V written by the rank holding their slot)
    against the plain decode core, on four ``gloo`` ranks of the CPU."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(tmp_path / "pg")], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in so, so + se[-3000:]
