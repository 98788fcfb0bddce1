"""The encoder's ``"ops"`` matcher (K3 plus the tensor step) and the measured
``matcher="auto"``: PyTorch port vs the JAX reference, on the CPU.

On the CPU the port's K3 wrapper runs its plain version.  Tolerance:
decisions and final carry identical to JAX ``encode_decisions`` with
``matcher="ops"`` (the Pallas kernel in interpret mode) and
``matcher="fused"``, and to the numpy oracle.  Thresholds sit between KS
jump points (multiples of 1/n), as ``critical_distance`` thresholds do.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from conftest import (GOLDEN_CASES, golden_codec_kwargs,  # noqa: E402
                      golden_signal)
from repro.core import encoder as jenc  # noqa: E402
from repro.core.npref import encode_decisions_np  # noqa: E402
from repro_torch import IdealemCodec  # noqa: E402
from repro_torch.core import encoder as tenc  # noqa: E402
from repro_torch.core import tuning  # noqa: E402
from repro_torch.errors import AutotuneCacheError  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _mixture_blocks(nb, n, seed=0):
    """Hits, misses and FIFO overwrites all occur on this traffic."""
    rng = np.random.default_rng(seed)
    parts = [rng.normal(m, s, size=(nb // 3, n))
             for m, s in [(0, 1), (5, 0.5), (0, 1)]]
    parts.append(rng.normal(0, 1, size=(nb - 3 * (nb // 3), n)))
    return np.concatenate(parts).astype(np.float32)


def _d_crit(n):
    return (int(0.4 * n) + 0.5) / n


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _same(want, got):
    for w, g in zip(want, got):
        _eq(w, g.numpy())


def _same_carry(jstate, tstate):
    for f in jenc.DictState._fields:
        _eq(getattr(jstate, f), getattr(tstate, f).numpy())


@pytest.mark.parametrize("num_dict,n", [(1, 7), (9, 24), (255, 32)])
def test_ops_matches_jax_ops_fused_and_numpy(num_dict, n):
    blocks = _mixture_blocks(45, n, seed=num_dict + n)
    kw = dict(num_dict=num_dict, d_crit=_d_crit(n), rel_tol=0.5)
    got, tstate = tenc.encode_decisions(
        torch.from_numpy(blocks), matcher="ops",
        state=tenc.init_state(num_dict, n, device="cpu"), **kw)
    for m in ("ops", "fused"):
        want, jstate = jenc.encode_decisions(
            jnp.asarray(blocks), matcher=m,
            state=jenc.init_state(num_dict, n), **kw)
        _same(want, got)
        _same_carry(jstate, tstate)
    _same(encode_decisions_np(blocks, **kw), got)


@pytest.mark.parametrize("use_minmax,use_ks",
                         [(False, True), (True, False), (False, False)])
def test_ops_ablations_match_jax(use_minmax, use_ks):
    blocks = _mixture_blocks(40, 16, seed=5)
    kw = dict(num_dict=7, d_crit=0.4, rel_tol=0.5, use_minmax=use_minmax,
              use_ks=use_ks)
    want = jenc.encode_decisions(jnp.asarray(blocks), matcher="ops", **kw)
    _same(want, tenc.encode_decisions(torch.from_numpy(blocks),
                                      matcher="ops", **kw))


def test_ops_batched_ragged_matches_jax():
    C, nb, n = 3, 30, 24
    blocks = np.stack([_mixture_blocks(nb, n, seed=s) for s in range(C)])
    valid = np.ones((C, nb), dtype=bool)
    valid[1, 20:] = False
    valid[2, ::4] = False
    kw = dict(num_dict=9, d_crit=_d_crit(n), rel_tol=0.5)
    want, jstate = jenc.encode_decisions_batched(
        jnp.asarray(blocks), valid=jnp.asarray(valid), matcher="ops",
        state=jenc.init_state(9, n, channels=C), **kw)
    got, tstate = tenc.encode_decisions_batched(
        torch.from_numpy(blocks), valid=torch.from_numpy(valid),
        state=tenc.init_state(9, n, channels=C, device="cpu"),
        matcher="ops", **kw)
    _same(want, got)
    _same_carry(jstate, tstate)
    assert not got[0][~torch.from_numpy(valid)].any()


def test_ops_chunked_resume_equals_one_shot_and_jax():
    blocks = _mixture_blocks(90, 24, seed=7)
    kw = dict(num_dict=7, d_crit=0.4, rel_tol=0.5)
    want = jenc.encode_decisions(jnp.asarray(blocks), matcher="ops", **kw)
    state = tenc.init_state(7, 24, device="cpu")
    parts = []
    for lo in range(0, 90, 17):
        out, state = tenc.encode_decisions(
            torch.from_numpy(blocks[lo:lo + 17]), state=state,
            matcher="ops", **kw)
        parts.append(out)
    for i in range(3):
        _eq(want[i], torch.cat([p[i] for p in parts]).numpy())


@pytest.mark.parametrize("matcher", ["ops", "auto"])
@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_golden_stream_with_codec_matcher(name, matcher, tmp_path,
                                          monkeypatch):
    """``IdealemCodec(matcher="ops"|"auto")`` reproduces the golden corpus
    byte for byte."""
    monkeypatch.setenv("REPRO_TORCH_ENCODE_AUTOTUNE",
                       str(tmp_path / "tune.json"))
    tenc.reset_encode_autotune()
    kw = golden_codec_kwargs(name)
    kw["backend"] = "torch"
    codec = IdealemCodec(device="cpu", decode_backend="numpy",
                         matcher=matcher, **kw)
    blob = codec.encode(golden_signal(name))
    path = os.path.join(os.path.dirname(__file__), "golden", f"{name}.idlm")
    with open(path, "rb") as f:
        assert blob == f.read()
    tenc.reset_encode_autotune()


# ------------------------------------------------------ measured autotuner
def test_encode_autotune_lifecycle(tmp_path, monkeypatch):
    """Mirrors tests/test_encode_fused.py's lifecycle: probe, cache,
    persist, reload, served from cache, stale and corrupt files."""
    path = str(tmp_path / "encode_autotune.json")
    monkeypatch.setenv("REPRO_TORCH_ENCODE_AUTOTUNE", path)
    tenc.reset_encode_autotune()
    blocks = torch.from_numpy(_mixture_blocks(12, 16, seed=1))
    kw = dict(num_dict=5, d_crit=0.4, rel_tol=0.5)
    assert not tenc.encode_autotune_cached(5, 16, torch.float32, "cpu")
    ref = tenc.encode_decisions(blocks, **kw)
    out = tenc.encode_decisions(blocks, matcher="auto", **kw)
    _same(tuple(r.numpy() for r in ref), out)  # whatever won, decisions agree
    assert tenc.encode_autotune_cached(5, 16, torch.float32, "cpu")
    assert os.path.exists(path)
    doc = json.load(open(path))
    assert doc["version"] == tenc.ENCODE_AUTOTUNE_VERSION
    (key, ent), = doc["entries"].items()
    assert key == "D=5|n=16|dtype=float32|device=cpu"
    assert ent["matcher"] in tenc.MATCHERS and ent["tile_d"] is None
    assert set(ent["times_us"]) == set(tenc.MATCHERS)

    # persisted choice survives a reset + reload; a second resolve is a hit
    tenc.reset_encode_autotune()
    assert tenc.load_encode_autotune(path) == 1
    assert tenc.encode_autotune_choices()[key] == ent["matcher"]
    probes_before = tenc._TUNER.stats["probes"]
    tenc.encode_decisions(blocks, matcher="auto", **kw)
    assert tenc._TUNER.stats["probes"] == probes_before  # served from cache
    assert tenc._TUNER.stats["hits"] >= 1
    tenc.save_encode_autotune(path)
    assert json.load(open(path)) == doc

    # stale version: strict load raises, non-strict discards and re-probes
    doc["version"] = 999
    with open(path, "w") as f:
        json.dump(doc, f)
    tenc.reset_encode_autotune()
    with pytest.raises(AutotuneCacheError):
        tenc.load_encode_autotune(path)
    tenc.reset_encode_autotune()
    assert tenc.load_encode_autotune(path, strict=False) == 0
    # corrupt file and malformed entry: strict raises, typed as ValueError
    with open(path, "w") as f:
        f.write("{not json")
    with pytest.raises(AutotuneCacheError) as e:
        tenc.load_encode_autotune(path)
    assert isinstance(e.value, ValueError)
    with open(path, "w") as f:
        json.dump({"version": tenc.ENCODE_AUTOTUNE_VERSION,
                   "entries": {key: {"matcher": "warp", "times_us": {}}}}, f)
    with pytest.raises(AutotuneCacheError, match="malformed"):
        tenc.load_encode_autotune(path)
    tenc.reset_encode_autotune()


def test_autotune_keys_include_device_and_dtype():
    keys = {tenc._matcher_key(255, 32, dt, dev)
            for dt in (torch.float32, torch.float64) for dev in ("cpu",)}
    assert keys == {"D=255|n=32|dtype=float32|device=cpu",
                    "D=255|n=32|dtype=float64|device=cpu"}


def test_probe_candidate_failure_makes_auto_raise(monkeypatch):
    """A matcher that fails in the probe is not dropped: "auto" raises, so
    a kernel that does not build or launch never hides behind another."""
    tenc.reset_encode_autotune()

    def broken(*args, **kw):
        raise RuntimeError("dict_match kernel launch failed: CUDA error 98")

    monkeypatch.setattr(ops, "dict_match", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        tenc.encode_decisions(torch.zeros((4, 8)), num_dict=3, d_crit=0.4,
                              matcher="auto")
    assert not tenc.encode_autotune_cached(3, 8, torch.float32, "cpu")
    tenc.reset_encode_autotune()


def test_unknown_matcher_rejected():
    blocks = torch.from_numpy(_mixture_blocks(6, 16))
    with pytest.raises(ValueError, match="unknown matcher"):
        tenc.encode_decisions(blocks, num_dict=3, d_crit=0.4, matcher="warp")
    with pytest.raises(ValueError, match="matcher"):
        IdealemCodec(matcher="warp", device="cpu")
    for m in ("reference", "ops", "fused", "auto"):
        assert IdealemCodec(matcher=m, device="cpu").matcher == m


def test_tuning_helpers():
    assert [tuning.pow2_bucket(n, 4, 64) for n in (1, 5, 16, 17, 1000)] == \
        [4, 8, 16, 32, 64]
    calls = []
    assert tuning.best_of(lambda: calls.append(1), reps=3) >= 0.0
    assert len(calls) == 4  # one warm-up + three timed
