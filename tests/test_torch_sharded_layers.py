"""The train and prefill layouts under a mesh, held to the plain forward
and backward on four ``gloo`` ranks of the CPU.

With the activation rules set, ``models/attention.py:_attend`` runs the
attention core on each rank's heads (q, k and v laid out by heads) or,
where the heads do not divide the model axis, on each rank's queries and
their positions against whole k and v (k's and v's gradients a pending
sum, reduced by ``DTensor``); ``models/lm.py:_residual`` pins the
residual stream and its gradient after every sublayer
(``models/common.py:_Pin``).  The dry run counts these layouts on meta
tensors; here they compute values.  On a (2, 2) ("data", "model") mesh,
with the sharding policy's parameter placements and the batch over
``data``: ``attention``, ``cross_attention`` and one decoder and one
encoder layer (``_apply_layer``) of whisper-tiny's SMOKE widths, in
float32, give the plain outputs and the plain gradients of the input,
the memory and every parameter leaf within 1e-5 of each tensor's largest
plain entry.  One config has 4 heads and 2 kv heads (split by heads),
one 3 heads (split by queries, as whisper's 6 heads are on 16 chips; a
head then straddles two shards of the projections' flat outputs).  The
worker counts ``shard_local`` calls, so each case proves it took its
sharded branch.
"""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")

WORKER = r"""
import sys, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config
from repro_torch.launch import sharding as shd
from repro_torch.models import attention as att, lm
from repro_torch.models.common import set_sharding_rules

TOL = 1e-5
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="file://" + sys.argv[2],
                        rank=rank, world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
calls = []
shard_local = att.shard_local


def counted(*args, **kw):
    calls.append(1)
    return shard_local(*args, **kw)


att.shard_local = counted
base = get_config("whisper-tiny", smoke=True).replace(
    dtype=torch.float32, param_dtype=torch.float32)
CASES = {"heads": (base.replace(num_kv_heads=2), 8, "model", None),
         "queries": (base.replace(d_model=48, num_heads=3, num_kv_heads=3),
                     10, None, "model")}


def leaves(tree, path=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in leaves(v, f"{path}.{k}")]
    return [(path, tree)]


def place(tree, plc):
    if isinstance(tree, dict):
        return {k: place(v, plc[k]) for k, v in tree.items()}
    return distribute_tensor(tree.detach(), mesh, plc).requires_grad_()


def run(fn, p, x, mem):
    out = fn(p, x, mem)
    out = out[0] if isinstance(out, tuple) else out
    return out, [x, mem] + [t for _, t in leaves(p)]


def check(name, got, want):
    scale = max(want.abs().max().item(), 1.0)
    err = (got - want).abs().max().item()
    assert err <= TOL * scale, (name, err, scale)


for case, (cfg, S, heads, queries) in CASES.items():
    rules = shd.activation_rules(cfg, mesh, ("data",))
    assert (rules["heads"], rules["queries"]) == (heads, queries), rules
    g = torch.Generator().manual_seed(0)
    params = lm.init_params(cfg, generator=g, device="cpu")
    plc = shd.to_shardings(shd.param_specs(params, cfg, mesh), mesh)
    B, M, d = 4, 6, cfg.d_model
    x = torch.randn(B, S, d, generator=g)
    mem = torch.randn(B, M, d, generator=g)
    w = torch.randn(B, S, d, generator=g)
    dec, enc = params["layers"][0], params["encoder"]["layers"][0]
    dplc, eplc = plc["layers"][0], plc["encoder"]["layers"][0]
    fns = {
        "attention": (lambda p, x, m: att.attention(p, x, cfg), dec["attn"],
                      dplc["attn"]),
        "cross_attention": (lambda p, x, m: att.cross_attention(p, x, m, cfg),
                            dec["cross"], dplc["cross"]),
        "dec_attn": (lambda p, x, m: lm._apply_layer("dec_attn", p, x, cfg,
                                                     m), dec, dplc),
        "enc_attn": (lambda p, x, m: lm._apply_layer("enc_attn", p, x, cfg,
                                                     m), enc, eplc),
    }
    bp = (Shard(0), Replicate())
    for fname, (fn, p, pp) in fns.items():
        plain = {k: t.detach().clone().requires_grad_()
                 for k, t in leaves(p)}
        px = x.clone().requires_grad_()
        pm = mem.clone().requires_grad_()
        pp_tree = {}
        for k, t in plain.items():  # back into the tree
            node = pp_tree
            parts = k.strip(".").split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = t
        want, wins = run(fn, pp_tree, px, pm)
        wgrads = torch.autograd.grad((want * w).sum(), wins,
                                     allow_unused=True)
        set_sharding_rules(rules)
        before = len(calls)
        try:
            dp = place(p, pp)
            dx = distribute_tensor(x, mesh, bp).requires_grad_()
            dm = distribute_tensor(mem, mesh, bp).requires_grad_()
            with implicit_replication():
                got, gins = run(fn, dp, dx, dm)
                full = got.full_tensor()
                ggrads = torch.autograd.grad((full * w).sum(), gins,
                                             allow_unused=True)
        finally:
            set_sharding_rules(None)
        assert len(calls) > before, (case, fname, "no sharded core")
        check((case, fname, "out"), full, want)
        names = ["x", "memory"] + [k for k, _ in leaves(p)]
        for n, gg, wg in zip(names, ggrads, wgrads):
            assert (gg is None) == (wg is None), (case, fname, n)
            if wg is not None:
                check((case, fname, n), gg.full_tensor(), wg)
dist.destroy_process_group()
print("RANK_OK", rank)
"""


def test_sharded_layers_match_plain_on_four_ranks(tmp_path):
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
