"""The port's trainer against the reference package on the CPU: the train
step, AdamW and its schedule, IDEALEM gradient compression, checkpoints,
the fault-tolerant driver, the data streams, the prefetcher and the
launcher.

Tolerances: train steps within 1e-4 (loss and metrics), 1e-4 on the
parameters (float32, absolute: the gradients are summed in another order,
and AdamW divides by their running scale, so an entry whose gradient is
near zero moves by up to lr either way), and each leaf of AdamW's
moments within 1e-4 of its largest reference entry plus 1e-12 (so a
moment of zeros or of the wrong scale fails); AdamW and the schedule within 1e-6
relative on identical trees; gradient compression bitwise on the
decisions, the reconstruction and the residual, its metrics within 1e-6;
checkpoint payloads byte for byte.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("zstandard")
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import encoder as jencoder  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import gradcomp as jgradcomp  # noqa: E402
from repro.runtime import FaultInjector as JaxInjector  # noqa: E402
from repro.runtime import FaultTolerantTrainer as JaxTrainer  # noqa: E402
from repro.train import init_train_state as jax_init_state  # noqa: E402
from repro.train import make_train_step as jax_train_step  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.data.pipeline import Prefetcher  # noqa: E402
from repro_torch.launch.train import build_batches  # noqa: E402
from repro_torch.models.convert import _split  # noqa: E402
from repro_torch.optim import adamw, gradcomp  # noqa: E402
from repro_torch.runtime import FaultInjector, FaultTolerantTrainer  # noqa: E402
from repro_torch.train import (init_train_state, make_train_step,  # noqa: E402
                               train_state_from_jax)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
CPU = torch.device("cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-30)))


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "gemma3_27b"])
def test_three_train_steps_match_jax(arch):
    """Three steps of ``make_train_step`` (lr 1e-3, microbatches 2) from
    the reference's initial state carried across; gemma3's local layers
    take the banded path (chunks of 4 positions)."""
    changes = {"attn_chunk": 4} if arch == "gemma3_27b" else {}
    jcfg = jax_config(arch, smoke=True).replace(dtype=jnp.float32, **changes)
    tcfg = get_config(arch, smoke=True).replace(dtype=torch.float32,
                                                **changes)
    jstate = jax_init_state(jax.random.key(0), jcfg)
    tstate = train_state_from_jax(_np(jstate), tcfg, CPU)
    assert tstate.opt.step.dtype == torch.int32 and tstate.gradcomp is None
    assert {t.dtype for t in tree_leaves(tstate.params)} == {torch.float32}
    jstep = jax.jit(jax_train_step(jcfg, lr=1e-3, microbatches=2))
    tstep = make_train_step(tcfg, lr=1e-3, microbatches=2)
    for batch in build_batches(tcfg, 3, 4, 32):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        assert set(tm) == set(jm) == {"loss", "grad_norm", "lr"}
        for k in jm:
            assert abs(float(tm[k]) - float(jm[k])) <= TOL * max(
                1.0, abs(float(jm[k]))), (k, float(tm[k]), float(jm[k]))
    assert int(tstate.opt.step) == int(jstate.opt.step) == 3
    for name, got, want in (("params", tstate.params, jstate.params),
                            ("mu", tstate.opt.mu, jstate.opt.mu),
                            ("nu", tstate.opt.nu, jstate.opt.nu)):
        want = tree_leaves(_split(_np(want), tcfg, CPU,
                                  lambda _: torch.float32))
        for i, (g, w) in enumerate(zip(tree_leaves(got), want)):
            err = float((g - w).abs().max())
            if name == "params":
                assert err <= TOL, (name, i, err)
            else:
                scale = float(w.abs().max())
                assert scale > 0 and err <= TOL * scale + 1e-12, \
                    (name, i, err, scale)


def test_train_step_with_gradcomp_runs_and_reports():
    cfg = get_config("granite_moe_1b_a400m", smoke=True)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), CPU,
                             use_gradcomp=True)
    assert {t.dtype for t in tree_leaves(state.params)} == {torch.float32}
    step = make_train_step(cfg, microbatches=2, use_gradcomp=True,
                           gradcomp_kw={"block": 256, "num_dict": 8})
    batch = build_batches(cfg, 1, 4, 16)[0]
    new, m = step(state, batch)
    assert set(m) == {"loss", "grad_norm", "lr", "hit_rate", "wire_ratio"}
    assert 0.0 <= float(m["hit_rate"]) <= 1.0 and float(m["wire_ratio"]) > 0
    res = tree_leaves(new.gradcomp.residual)
    assert any(float(r.abs().max()) > 0 for r in res) or \
        float(m["hit_rate"]) == 0.0
    # the state passed in is not modified
    assert int(state.opt.step) == 0 and int(new.opt.step) == 1
    with pytest.raises(ValueError, match="microbatches"):
        step(state, build_batches(cfg, 1, 3, 16)[0])


# ------------------------------------------------------------------ AdamW
def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"b": {"w": rng.normal(size=(5, 3)).astype(np.float32) * scale,
                  "u": rng.normal(size=(7,)).astype(np.float32) * scale},
            "a": [rng.normal(size=(4,)).astype(np.float32) * scale,
                  rng.normal(size=(2, 2)).astype(np.float32) * scale]}


@pytest.mark.parametrize("clip,wd", [(1.0, 0.1), (None, 0.0), (100.0, 0.3)])
def test_adamw_update_matches_jax(clip, wd):
    params, grads = _tree(0), _tree(1, scale=3.0)
    jp = jax.tree.map(jnp.asarray, params)
    jst = jadamw.init(jp)
    tp = tree_map(torch.from_numpy, params)
    tst = adamw.init(tp)
    assert tst.step.dtype == torch.int32 and tst.step.shape == ()
    for i in range(3):
        g = _tree(10 + i, scale=3.0)
        jp, jst, jm = jadamw.update(jax.tree.map(jnp.asarray, g), jst, jp,
                                    lr=0.01, weight_decay=wd, clip_norm=clip)
        tp, tst, tm = adamw.update(tree_map(torch.from_numpy, g), tst, tp,
                                   lr=0.01, weight_decay=wd, clip_norm=clip)
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-6
    assert int(tst.step) == 3
    for got, want in ((tp, jp), (tst.mu, jst.mu), (tst.nu, jst.nu)):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


def test_adamw_with_schedule_and_global_norm():
    params = _tree(2)
    sched, jsched = adamw.warmup_cosine(0.1, 3, 10), \
        jadamw.warmup_cosine(0.1, 3, 10)
    for step in range(0, 13):
        want = float(jsched(jnp.asarray(step, jnp.int32)))
        assert abs(float(sched(torch.tensor(step, dtype=torch.int32)))
                   - want) <= 1e-6 * max(want, 1e-3)
        assert abs(float(sched(step)) - float(jsched(step))) <= 1e-7
    tp = tree_map(torch.from_numpy, params)
    _, st, m = adamw.update(tp, adamw.init(tp), tp, lr=sched)
    assert float(m["lr"]) == pytest.approx(float(jsched(1)), rel=1e-6)
    assert _rel(adamw.global_norm(tp), jadamw.global_norm(
        jax.tree.map(jnp.asarray, params))) <= 1e-6


# --------------------------------------------------------- gradient comp.
def _gradient_tree(seed):
    """Gradient-like leaves: blocks from a few distributions, so some hit
    and some miss a 32-entry dictionary, and tails shorter than a block."""
    rng = np.random.default_rng(seed)

    def leaf(n):
        scales = rng.choice([1e-3, 2e-3, 5e-2], size=n // 256 + 1)
        return (rng.normal(size=n) * np.repeat(scales, 256)[:n]).astype(
            np.float32)

    return {"w": leaf(256 * 40).reshape(40, 256),
            "z": {"k": leaf(256 * 13 + 100), "b": leaf(300)},
            "l": [leaf(256 * 7).reshape(7, 256), leaf(17)]}


@pytest.mark.parametrize("kw", [dict(), dict(block=128, num_dict=8,
                                              alpha=0.01, rel_tol=0.3)])
def test_gradcomp_matches_jax_bitwise(kw):
    grads, residual = _gradient_tree(3), _gradient_tree(4)
    residual = jax.tree.map(lambda r: r * 0.1, residual)
    jg = jax.tree.map(jnp.asarray, grads)
    jst = jgradcomp.GradCompState(jax.tree.map(jnp.asarray, residual))
    tst = gradcomp.GradCompState(tree_map(torch.from_numpy, residual))
    for _ in range(2):  # the second step feeds the residual back
        jout, jst, jm = jgradcomp.compress(jg, jst, **kw)
        tout, tst, tm = gradcomp.compress(tree_map(torch.from_numpy, grads),
                                          tst, **kw)
        for got, want in ((tout, jout), (tst.residual, jst.residual)):
            for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
                assert g.dtype == torch.float32
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for k in ("hit_rate", "wire_ratio"):
            assert _rel(tm[k], jm[k]) <= 1e-6, k
    assert 0.0 < float(tm["hit_rate"]) < 1.0


def test_gradcomp_decisions_equal_the_reference_scan(monkeypatch):
    """K1's plain version against the reference's scan on the flattened
    gradient, in one call and chunked through the resumable carry (as
    the card does where one launch would pass K1's int32 range)."""
    flat = np.concatenate([x.reshape(-1) for x in
                           jax.tree.leaves(_gradient_tree(5))])
    block, D = 256, 32
    d_crit = float(gradcomp.critical_distance(0.05, block, block))
    nb = flat.size // block
    blocks = flat[:nb * block].reshape(nb, block)
    jh, js, _ = jencoder.encode_decisions(jnp.asarray(blocks), num_dict=D,
                                          d_crit=d_crit, rel_tol=0.5)
    tb = torch.from_numpy(blocks)
    for limit in (2 ** 31, 256 * 7 + 1):
        monkeypatch.setattr(gradcomp, "K1_ELEMENTS", limit)
        th, ts = gradcomp._decide(tb, num_dict=D, d_crit=d_crit,
                                  rel_tol=0.5)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    src = gradcomp.hit_sources(th, ts).numpy()
    last = {}
    for i, (h, s) in enumerate(zip(np.asarray(jh), np.asarray(js))):
        if not h:
            last[int(s)] = i
        assert src[i] == (last[int(s)] if h else i)


# -------------------------------------------------------------- checkpoint
def _ckpt_tree():
    rng = np.random.default_rng(6)
    return {"params": {"w": torch.from_numpy(
                rng.normal(size=(64, 128)).astype(np.float32)),
            "h": torch.from_numpy(rng.normal(size=(8, 8))).to(
                torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32),
            "host": np.arange(12, dtype=np.float64).reshape(3, 4),
            "none": None}


def test_checkpoint_round_trip_and_manifest(tmp_path):
    tree = _ckpt_tree()
    final = ckpt.save(str(tmp_path), 5, tree)
    assert final == str(tmp_path / "step_00000005")
    assert ckpt.latest_step(str(tmp_path)) == 5
    man = json.loads((tmp_path / "step_00000005" / "manifest.json")
                     .read_text())
    assert man["step"] == 5 and "treedef" in man
    # leaves in jax.tree order: host, params/h, params/w, step
    assert [(m["shape"], m["dtype"], m["codec"]) for m in man["leaves"]] \
        == [([3, 4], "float64", "none"), ([8, 8], "bfloat16", "none"),
            ([64, 128], "float32", "none"), ([], "int32", "none")]
    assert (tmp_path / "step_00000005" / "leaf_1.bin").read_bytes() == \
        tree["params"]["h"].view(torch.int16).numpy().tobytes()
    out = ckpt.restore(str(tmp_path), 5, tree)
    assert out["none"] is None and isinstance(out["host"], np.ndarray)
    np.testing.assert_array_equal(out["host"], tree["host"])
    for k in ("w", "h"):
        assert out["params"][k].dtype == tree["params"][k].dtype
        assert torch.equal(out["params"][k], tree["params"][k])
    assert out["step"].dtype == torch.int32 and int(out["step"]) == 7
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.restore(str(tmp_path), 5, {"w": tree["params"]["w"]})


def test_checkpoint_leaf_codecs_are_the_reference_s(tmp_path):
    tree = _ckpt_tree()
    w = tree["params"]["w"].numpy()
    for codec in ("zstd", "idealem", "none"):
        blob, used = ckpt.ckpt._encode_leaf(w, codec)
        assert (blob, used) == jckpt.ckpt._encode_leaf(w, codec)
    assert ckpt.ckpt._encode_leaf(w, "idealem")[1] == "idealem"
    small = np.ones(100, np.float32)  # under 4096 values: raw
    assert ckpt.ckpt._encode_leaf(small, "idealem") == \
        jckpt.ckpt._encode_leaf(small, "idealem")
    for codec in ("zstd", "idealem"):
        d = tmp_path / codec
        ckpt.save(str(d), 1, tree, codec=codec)
        # the reference reads the port's leaf files
        man = json.loads((d / "step_00000001" / "manifest.json").read_text())
        i = [m["shape"] for m in man["leaves"]].index([64, 128])
        data = (d / "step_00000001" / f"leaf_{i}.bin").read_bytes()
        want = jckpt.ckpt._decode_leaf(data, man["leaves"][i]["codec"],
                                       [64, 128], "float32")
        out = ckpt.restore(str(d), 1, tree)
        np.testing.assert_array_equal(out["params"]["w"].numpy(), want)
        if codec == "zstd":
            np.testing.assert_array_equal(want, w)
        assert torch.equal(out["params"]["h"], tree["params"]["h"])


def test_checkpoint_tmp_ignored_and_async_save(tmp_path):
    tree = {"a": torch.ones(128)}
    ckpt.save(str(tmp_path), 1, tree)
    os.makedirs(tmp_path / "step_00000099.tmp")  # a crash mid-write
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert ckpt.latest_step(str(tmp_path / "nothing")) is None
    t = ckpt.async_save(str(tmp_path), 3, tree)
    tree["a"].add_(1)  # the snapshot was taken before the thread started
    t.join(timeout=60)
    assert not t.is_alive()
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert torch.equal(ckpt.restore(str(tmp_path), 3, tree)["a"],
                       torch.ones(128))


# --------------------------------------------------------- fault tolerance
def _numpy_step(state, batch):
    """A deterministic step over numpy: w moves by the batch's mean."""
    w = np.asarray(state["w"]) + np.asarray(batch["tokens"]).mean() * 1e-3
    return {"w": w}, {"loss": float(np.abs(w).sum())}


@pytest.mark.parametrize("schedule,deadline", [
    ({6: "crash"}, None), ({2: "nan", 5: "crash"}, None),
    ({3: "straggler"}, 1e-9), ({1: "straggler", 4: "nan"}, 1e-9)])
def test_fault_tolerant_trainer_logs_as_the_reference(tmp_path, schedule,
                                                      deadline):
    batches = list(synthetic.token_stream(10, 4, 8, 64))
    logs, finals = [], []
    for Trainer, Injector, d in ((JaxTrainer, JaxInjector, "ref"),
                                 (FaultTolerantTrainer, FaultInjector,
                                  "port")):
        tr = Trainer(train_step=_numpy_step,
                     state={"w": np.zeros(4, np.float64)},
                     ckpt_dir=str(tmp_path / d), ckpt_every=4,
                     injector=Injector(dict(schedule)),
                     step_deadline_s=deadline)
        tr.run(batches, 10)
        logs.append([{k: v for k, v in e.items() if k != "time_s"}
                     for e in tr.log])
        finals.append(np.asarray(tr.state["w"]))
    assert logs[0] == logs[1]
    np.testing.assert_array_equal(finals[0], finals[1])
    assert any("event" in e for e in logs[1])
    assert ckpt.latest_step(str(tmp_path / "port")) == 10


def test_trainer_restores_a_torch_state_after_a_crash(tmp_path):
    cfg = get_config("granite_moe_1b_a400m", smoke=True)
    state = init_train_state(cfg, torch.Generator().manual_seed(0), CPU)
    tr = FaultTolerantTrainer(
        train_step=make_train_step(cfg, lr=1e-3, microbatches=2),
        state=state, ckpt_dir=str(tmp_path), ckpt_every=2,
        injector=FaultInjector({3: "crash"}))
    tr.run(build_batches(cfg, 5, 4, 16), 5)
    ev = [e for e in tr.log if "event" in e]
    assert ev == [{"step": 3, "event": "restore", "resumed_from": 2,
                   "cause": "node failure at step 3"}]
    assert [e["step"] for e in tr.log if "loss" in e] == [0, 1, 2, 2, 3, 4]
    assert int(tr.state.opt.step) == 5
    assert {t.device.type for t in tree_leaves(tr.state)} == {"cpu"}


# ------------------------------------------------------------------- data
def test_token_stream_and_eeg_like_are_the_reference_s():
    for a, b in zip(synthetic.token_stream(3, 4, 9, 100, seed=2),
                    jsynthetic.token_stream(3, 4, 9, 100, seed=2)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    for n, alpha in ((1000, 1.0), (4097, 1.5), (64, 0.5)):
        np.testing.assert_array_equal(
            synthetic.eeg_like(n, alpha=alpha, seed=3),
            jsynthetic.eeg_like(n, alpha=alpha, seed=3))


def test_prefetcher_keeps_order_and_ends():
    items = [{"i": i} for i in range(25)]
    got = list(Prefetcher(iter(items), prefetch=3,
                          place=lambda b: {"i": b["i"] * 2}))
    assert got == [{"i": 2 * i} for i in range(25)]
    assert list(Prefetcher(iter(items))) == \
        list(jpipeline.Prefetcher(iter(items)))
    assert list(Prefetcher(iter([]))) == []


def test_launcher_restores_after_an_injected_crash(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "4", "--inject-crash", "2",
         "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("done: 4 steps")
    assert "'event': 'restore', 'resumed_from': 0" in last
    assert "node failure at step 2" in last


def test_no_port_module_imports_zstandard_when_imported(tmp_path):
    """``zstandard`` is loaded only where a zstd leaf is written or read
    (the card's machine may not have it)."""
    code = ("import pkgutil, importlib, sys, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "assert 'zstandard' not in sys.modules\n"
            "import repro_torch.checkpoint as c, numpy as np\n"
            "c.save(sys.argv[1], 1, {'a': np.ones(3)})\n"
            "assert 'zstandard' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "step_00000001" / "manifest.json").exists()
