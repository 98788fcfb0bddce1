"""The scale-out encode of the PyTorch port vs the JAX reference, on the CPU.

The port drives every shard of an encode plan from one process; here the
shards are ``"cpu"`` listed several times (the port's counterpart of the
reference's forced host device count).  Held against the reference:

  * the channel-sharded, dictionary-sharded and mixed-sharded scans
    against the reference's batched scans, and against its
    ``encode_decisions_dsharded`` on 4 forced host devices (a
    subprocess);
  * planned sessions' bytes against the reference's sessions without a
    plan, over every mode, D in {1, 2, 255}, f64/f32/f16 and with and
    without the error bound, each run past ``count >= D``;
  * planned coalescers and adaptive sessions.

Inputs are made from a seed with numpy.  Tolerance: none -- decisions,
final carries and bytes equal.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import IdealemCodec as JaxCodec  # noqa: E402
from repro.core import encoder as jenc  # noqa: E402
from repro.core.select import SelectorConfig as JaxSelectorConfig  # noqa: E402
from repro.serve import FlushPolicy as JaxFlushPolicy  # noqa: E402
from repro.serve import StreamCoalescer as JaxStreamCoalescer  # noqa: E402
from repro_torch import IdealemCodec  # noqa: E402
from repro_torch.core import encoder as tenc  # noqa: E402
from repro_torch.core.select import SelectorConfig  # noqa: E402
from repro_torch.kernels import dict_match as k3  # noqa: E402
from repro_torch.kernels import encode_step as k1  # noqa: E402
from repro_torch.launch.encode_plan import make_encode_plan  # noqa: E402
from repro_torch.serve import FlushPolicy, StreamCoalescer  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
CPU4 = ["cpu"] * 4
KW = dict(d_crit=0.45, rel_tol=0.5)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _same_out(jax_out, torch_out):
    for x, y in zip(jax_out, torch_out):
        _eq(x, y.numpy())


def _same_state(jax_state, torch_state):
    for f in tenc.DictState._fields:
        _eq(getattr(jax_state, f), getattr(torch_state, f).numpy())


def _blocks(C, nb, n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(C, nb, n)).astype(np.float32)


def _wrapping(C, nb, B, seed):
    """Blocks of seeded levels and scales (1.03**k, k < 300), a fifth of
    them repeats of one of the 39 blocks before: under ``rel_tol=0.03`` most blocks
    miss, so a 255-row dictionary wraps, and the repeats hit.  Plus a
    5-sample tail.  ``(C, nb * B + 5)`` float64."""
    rng = np.random.default_rng(seed)
    lev = rng.integers(0, 100, (C, nb, 1)) * 1.0
    scale = 1.03 ** rng.integers(0, 300, (C, nb, 1))
    x = lev + scale * rng.normal(0, 1, (C, nb, B))
    rep = rng.random((C, nb)) < 0.2
    back = rng.integers(1, 40, (C, nb))
    for c in range(C):
        for b in range(nb):
            if rep[c, b] and back[c, b] <= b:
                x[c, b] = x[c, b - back[c, b]]
    return np.concatenate([x.reshape(C, -1), rng.normal(0, 1, (C, 5))], 1)


# ------------------------------------------------ scans against the reference
@pytest.mark.parametrize("plan_kind", ["sharded", "dsharded"])
def test_masked_scan_is_noop_on_invalid_blocks(plan_kind):
    """Masked blocks interleaved with real ones through a planned scan:
    real positions decide as the reference's unmasked scan, masked ones
    all-zero, and the final carry is the unmasked one (a pad lane's carry
    stays empty)."""
    C, nb = 3, 50
    blocks = _blocks(C, nb, 16, seed=0)
    kw = dict(num_dict=5, **KW)
    ref, ref_state = jenc.encode_decisions_batched(
        blocks, state=jenc.init_state(5, 16, channels=C), **kw)
    blk2 = np.zeros((C + 1, 2 * nb, 16), np.float32)
    blk2[:C, ::2] = blocks
    valid = np.zeros((C + 1, 2 * nb), dtype=bool)
    valid[:C, ::2] = True
    st = tenc.init_state(5, 16, channels=C + 1, device="cpu")
    x, v = torch.as_tensor(blk2), torch.as_tensor(valid)
    if plan_kind == "sharded":
        out, sh = tenc.encode_decisions_sharded(
            x, devices=["cpu"] * 2, state=st, valid=v, **kw)
    else:
        out, sh = tenc.encode_decisions_dsharded(
            x, grid=[["cpu"] * 2] * 2, state=st, valid=v, **kw)
    for i in range(3):
        _eq(np.asarray(ref[i]), out[i][:C, ::2].numpy())
        assert not out[i][:, 1::2].any() and not out[i][C].any()
    joined = tenc.join_state(sh)
    _same_state(ref_state, tenc.DictState(*(f[:C] for f in joined)))
    assert int(joined.count[C]) == 0 and not joined.valid[C].any()


@pytest.mark.parametrize("shards", [1, 3])
@pytest.mark.parametrize("matcher", [None, "fused"])
def test_sharded_single_device_matches_batched(shards, matcher):
    bc = _blocks(3, 40, 16, seed=1)
    kw = dict(num_dict=7, **KW)
    ref = jenc.encode_decisions_batched(bc, **kw)
    out = tenc.encode_decisions_sharded(
        torch.as_tensor(bc), devices=["cpu"] * shards, matcher=matcher, **kw)
    _same_out(ref, out)


def test_sharded_rejects_channels_off_the_shard_count():
    with pytest.raises(ValueError, match="pad via EncodePlan"):
        tenc.encode_decisions_sharded(torch.zeros(3, 4, 8), devices=CPU4[:2],
                                      num_dict=3, d_crit=0.5)
    with pytest.raises(ValueError, match="pad via EncodePlan"):
        tenc.encode_decisions_dsharded(torch.zeros(3, 4, 8),
                                       grid=[["cpu"]] * 2, num_dict=3,
                                       d_crit=0.5)


@pytest.mark.parametrize("grid", [(1, 1), (1, 2), (1, 4), (3, 2)])
@pytest.mark.parametrize("matcher", [None, "fused"])
def test_dsharded_single_device_matches_batched(grid, matcher):
    """Dictionary rows split over CPU shards (D=7 pads to 8), each step's
    best match reduced across them: the reference's batched scan, with the
    plain matcher and with ``"fused"`` (which runs K3 here, its plain
    version on the CPU)."""
    bc = _blocks(3, 40, 16, seed=1)
    kw = dict(num_dict=7, **KW)
    ref, ref_state = jenc.encode_decisions_batched(
        bc, state=jenc.init_state(7, 16, channels=3), **kw)
    groups, shards = grid
    out, sh = tenc.encode_decisions_dsharded(
        torch.as_tensor(bc), grid=[["cpu"] * shards] * groups,
        matcher=matcher, state=tenc.init_state(7, 16, channels=3,
                                               device="cpu"), **kw)
    _same_out(ref, out)
    _same_state(ref_state, tenc.join_state(sh))


def test_dsharded_fused_runs_k3_once_a_shard_a_step(monkeypatch):
    """``"fused"`` resolves to K3 under D-sharding: its wrapper is called
    once per shard per block step, and K1's never."""
    calls = {"k3": 0, "k1": 0}
    real3 = k3.dict_match_cuda

    def spy3(*a, **kw):
        calls["k3"] += 1
        return real3(*a, **kw)

    monkeypatch.setattr(k3, "dict_match_cuda", spy3)
    monkeypatch.setattr(k1, "encode_scan", lambda *a, **kw: calls.update(
        k1=calls["k1"] + 1))
    bc = torch.as_tensor(_blocks(2, 12, 8, seed=2))
    tenc.encode_decisions_dsharded(bc, grid=[CPU4], num_dict=255,
                                   matcher="fused", **KW)
    assert calls == {"k3": 12 * 4, "k1": 0}


def test_sharded_fused_runs_k1_once_a_shard(monkeypatch):
    calls = []
    real = k1.encode_scan

    def spy(xs, valid, state, **kw):
        calls.append((tuple(xs.shape), kw.get("chan") is not None))
        return real(xs, valid, state, **kw)

    monkeypatch.setattr(k1, "encode_scan", spy)
    bc = torch.as_tensor(_blocks(8, 12, 8, seed=2))
    tenc.encode_decisions_sharded(bc, devices=CPU4, num_dict=9,
                                  matcher="fused", **KW)
    assert calls == [((2, 12, 8), False)] * 4
    calls.clear()
    n = np.array([8, 7] * 4)
    tenc.encode_decisions_mixed_sharded(
        bc, devices=CPU4, num_dict=9, n_valid=n, d_crit=np.full(8, 0.45),
        rel_tol=0.5, matcher="fused")
    assert calls == [((2, 12, 8), True)] * 4


@pytest.mark.parametrize("eb", [None, 0.8])
def test_mixed_sharded_matches_reference_mixed(eb):
    """Lanes of widths 16 and 15 (+inf padded), per-lane thresholds and
    error metrics, split over 2 CPU shards with a pad lane: the
    reference's ``encode_decisions_mixed``, carry included."""
    C, nb, n = 4, 30, 16
    rng = np.random.default_rng(4)
    blocks = rng.normal(size=(C, nb, n)).astype(np.float32)
    widths = np.array([16, 15, 16, 15])
    blocks[widths == 15, :, 15] = np.inf
    d_crit = np.array([0.45, 0.5, 0.4, 0.45], np.float32)
    err_cum = np.array([False, True, False, True])
    valid = np.ones((C, nb), bool)
    kw = dict(num_dict=6, n_valid=widths, d_crit=d_crit, rel_tol=0.5,
              error_bound=eb, error_cumulative=err_cum)
    ref, ref_state = jenc.encode_decisions_mixed(
        blocks[:3], state=jenc.init_state(6, n, channels=3,
                                          raw=eb is not None),
        valid=valid[:3], **dict(kw, n_valid=widths[:3], d_crit=d_crit[:3],
                                error_cumulative=err_cum[:3]))
    valid[3] = False
    for matcher in (None, "fused"):
        out, sh = tenc.encode_decisions_mixed_sharded(
            torch.as_tensor(blocks), devices=["cpu"] * 2, matcher=matcher,
            state=tenc.init_state(6, n, channels=C, device="cpu",
                                  raw=eb is not None),
            valid=torch.as_tensor(valid), **kw)
        for i in range(3):
            _eq(np.asarray(ref[i]), out[i][:3].numpy())
            assert not out[i][3].any()
        joined = tenc.join_state(sh)
        _same_state(ref_state, tenc.DictState(*(f[:3] for f in joined)))


_FORCED = r"""
import sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro.core import encoder as jenc

assert jax.device_count() == 4, jax.devices()
src = np.load(sys.argv[1])
out = {}
for key in ("g14_D1", "g14_D255", "g22_D5_eb"):
    blocks, valid = src[key + "_blocks"], src[key + "_valid"]
    groups = 2 if key.startswith("g22") else 1
    D = int(key.split("_D")[1].split("_")[0])
    eb = 0.8 if key.endswith("_eb") else None
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(groups, 4 // groups),
                ("channels", "dict"))
    st = jenc.init_state(D, blocks.shape[-1], channels=blocks.shape[0],
                         raw=eb is not None)
    (h, s, o), new = jenc.encode_decisions_dsharded(
        blocks, mesh=mesh, ch_axis="channels", dict_axis="dict",
        num_dict=D, d_crit=0.45, rel_tol=0.03, error_bound=eb, state=st,
        valid=valid)
    for name, v in zip(("is_hit", "slot", "overwrite"), (h, s, o)):
        out[f"{key}_{name}"] = np.asarray(v)
    for f in jenc.DictState._fields:
        out[f"{key}_{f}"] = np.asarray(getattr(new, f))
np.savez(sys.argv[2], **out)
print("ok")
"""


def test_dsharded_equals_reference_on_four_forced_host_devices(tmp_path):
    """The reference's ``encode_decisions_dsharded`` on 4 forced host
    devices (a subprocess, so the device-count flag precedes the jax
    import) against the port's scan on 4 CPU shards: a 1 x 4 grid at D=1
    (three shards hold only pad rows) and D=255 (one pad row; the FIFO
    wraps), and a 2 x 2 grid with the error bound; masked blocks in each.
    Decisions and final carry equal."""
    cases = {}
    for key, C, nb in (("g14_D1", 2, 40), ("g14_D255", 2, 420),
                       ("g22_D5_eb", 4, 60)):
        x = _wrapping(C, nb, 8, seed=len(cases))[:, :nb * 8]
        valid = np.random.default_rng(5).random((C, nb)) > 0.1
        cases[key + "_blocks"] = x.reshape(C, nb, 8).astype(np.float32)
        cases[key + "_valid"] = valid
    np.savez(tmp_path / "in.npz", **cases)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run(
        [sys.executable, "-c", _FORCED, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    want = np.load(tmp_path / "out.npz")
    wrapped = 0
    for key, grid in (("g14_D1", [CPU4]), ("g14_D255", [CPU4]),
                      ("g22_D5_eb", [["cpu"] * 2] * 2)):
        blocks = torch.as_tensor(cases[key + "_blocks"])
        D = int(key.split("_D")[1].split("_")[0])
        eb = 0.8 if key.endswith("_eb") else None
        st = tenc.init_state(D, 8, channels=blocks.shape[0], device="cpu",
                             raw=eb is not None)
        out, sh = tenc.encode_decisions_dsharded(
            blocks, grid=grid, num_dict=D, d_crit=0.45, rel_tol=0.03,
            error_bound=eb, state=st,
            valid=torch.as_tensor(cases[key + "_valid"]))
        for name, got in zip(("is_hit", "slot", "overwrite"), out):
            _eq(want[f"{key}_{name}"], got.numpy())
        joined = tenc.join_state(sh)
        for f in tenc.DictState._fields:
            _eq(want[f"{key}_{f}"], getattr(joined, f).numpy())
        wrapped += int((joined.count > D).all())
    assert wrapped == 3  # every case ran past count >= D


# ------------------------------------------- planned sessions == reference
# (mode, D, stream dtype, error bound, value_range, port backend): every
# mode, D and dtype, the bound on and off
SESSION_CELLS = [
    ("std", 1, np.float64, None, None, "cuda"),
    ("std", 2, np.float32, 5.0, None, "torch"),
    ("std", 255, np.float16, None, None, "cuda"),
    ("residual", 1, np.float32, 5.0, None, "cuda"),
    ("residual", 2, np.float16, None, (0.0, 360.0), "cuda"),
    ("residual", 255, np.float64, 5.0, None, "cuda"),
    ("delta", 1, np.float16, None, None, "torch"),
    ("delta", 2, np.float64, 5.0, (0.0, 360.0), "cuda"),
    ("delta", 255, np.float32, None, None, "cuda"),
]


def _blobs(codec, x, dtype, plan=None):
    """Two feeds of equal block counts, then the 5-sample tail alone."""
    s = codec.session(channels=x.shape[0], dtype=dtype, plan=plan)
    half = (x.shape[1] - 5) // 2
    cuts = [0, half, 2 * half, x.shape[1]]
    parts = [s.feed(x[:, a:b]) for a, b in zip(cuts, cuts[1:])]
    parts.append(s.finish())
    return [b"".join(p[c] for p in parts) for c in range(x.shape[0])], s


@pytest.mark.parametrize("mode,D,dtype,eb,vr,backend", SESSION_CELLS)
def test_planned_sessions_equal_reference_bytes(mode, D, dtype, eb, vr,
                                                backend):
    """3 channels of 420 blocks (120 at D < 255) and a tail, fed in 3
    chunks: the port's
    sessions with a 2-shard channel plan (one pad lane), a 4-shard
    dictionary plan and a 2 x 2 plan emit the reference's bytes (its
    ``jax`` backend, no plan)."""
    x = _wrapping(3, 420 if D == 255 else 120, 8, seed=D)
    if vr is not None:
        x = np.mod(x, 360.0)
    cfg = dict(mode=mode, block_size=8, num_dict=D, alpha=0.05,
               rel_tol=0.03, value_range=vr, error_bound=eb)
    want, jsess = _blobs(JaxCodec(backend="jax", **cfg), x, dtype)
    codec = IdealemCodec(backend=backend, device="cpu", **cfg)
    plans = [make_encode_plan(3, block_size=8, devices=CPU4[:2]),
             make_encode_plan(3, block_size=8, devices=CPU4, dict_shards=4),
             make_encode_plan(3, block_size=8, devices=CPU4, dict_shards=2)]
    assert [(p.padded_channels, len(p.grid), len(p.grid[0]))
            for p in plans] == [(4, 2, 1), (3, 1, 4), (4, 2, 2)]
    for plan in plans:
        got, sess = _blobs(codec, x, dtype, plan=plan)
        assert got == want, plan.summary()
    misses = [st.blocks - st.hits for st in jsess.stats]
    assert min(misses) > D and max(st.hits for st in jsess.stats) > 0


def test_planned_session_rejects_a_plan_of_another_size():
    codec = IdealemCodec(mode="std", block_size=8, num_dict=4,
                         device="cpu")
    with pytest.raises(ValueError, match="plan is for 2 channels"):
        codec.session(channels=3, plan=make_encode_plan(2, devices=CPU4))
    with pytest.raises(ValueError, match="device backend"):
        IdealemCodec(mode="std", block_size=8, num_dict=4, device="cpu",
                     backend="numpy").session(
            plan=make_encode_plan(1, devices=["cpu"]))


# ----------------------------------------------------- planned coalescers
def _drive(co, signals, steps):
    segs = {sid: [] for sid in signals}
    for sid in signals:
        co.open_stream(sid)
    offs = dict.fromkeys(signals, 0)
    while any(offs[sid] < len(x) for sid, x in signals.items()):
        for sid, x in signals.items():
            if offs[sid] < len(x):
                res = co.submit(sid, x[offs[sid]:offs[sid] + steps[sid]])
                offs[sid] += steps[sid]
                for k, v in (res or {}).items():
                    segs[k].append(v)
    for sid in signals:
        segs[sid].append(co.close_stream(sid))
    return {sid: b"".join(v) for sid, v in segs.items()}


@pytest.mark.parametrize("plan_kind", ["sharded", "dsharded"])
def test_coalescer_matches_per_stream_service(plan_kind):
    """Coalesced ragged traffic through a planned coalescer (8 slots over 4
    CPU shards, or 2 x 2 with the dictionary split) decodes like the
    per-stream path, and its bytes are the reference's coalescer's."""
    B = 16
    kw = dict(mode="residual", block_size=B, num_dict=31, alpha=0.05,
              rel_tol=0.5)
    rng = np.random.default_rng(3)
    signals = {f"s{i}": rng.normal(i, 1.0, size=B * 50 + 3 * i)
               for i in range(5)}
    steps = {sid: 29 + 17 * i for i, sid in enumerate(signals)}
    plan = make_encode_plan(8, block_size=B, devices=CPU4,
                            dict_shards=2 if plan_kind == "dsharded" else 1)
    co = StreamCoalescer(policy=FlushPolicy(max_batch_blocks=40), plan=plan,
                         backend="torch", device="cpu", **kw)
    got = _drive(co, signals, steps)
    assert co.capacity == 8
    want = _drive(JaxStreamCoalescer(policy=JaxFlushPolicy(
        max_batch_blocks=40), capacity=8, backend="jax", **kw),
        signals, steps)
    assert got == want
    codec = JaxCodec(**kw)
    for sid, x in signals.items():
        _eq(codec.decode(got[sid]), codec.decode(codec.encode(x)))
    assert co.stats()["blocks"] == sum(len(x) // B for x in signals.values())
    for i in range(8):  # the closed streams' slots are free again
        co.open_stream(f"t{i}")
    with pytest.raises(RuntimeError, match="plan-pinned"):
        co.open_stream("t8")


@pytest.mark.parametrize("plan_kind", ["sharded", "dsharded"])
def test_coalescer_slot_reuse_is_fresh(plan_kind):
    """A recycled slot of a planned coalescer must not leak the previous
    stream's dictionary, on whichever shard the slot lives."""
    kw = dict(mode="std", block_size=16, num_dict=7, alpha=0.05, rel_tol=0.5)
    codec = JaxCodec(**kw)
    rng = np.random.default_rng(9)
    x = rng.normal(size=16 * 40)
    plan = make_encode_plan(2, block_size=16, devices=CPU4[:2],
                            dict_shards=2 if plan_kind == "dsharded" else 1)
    co = StreamCoalescer(plan=plan, backend="cuda", device="cpu", **kw)
    for name in ("a", "b", "c", "d"):
        co.open_stream(name)
        co.submit(name, x)
        blob = co.close_stream(name)
        _eq(codec.decode(blob), codec.decode(codec.encode(x)))
    with pytest.raises(KeyError):
        co.submit("a", x)


def test_coalescer_rejects_plans_it_cannot_take():
    kw = dict(mode="std", block_size=16, num_dict=7, device="cpu")
    with pytest.raises(ValueError, match="padded channel count"):
        StreamCoalescer(plan=make_encode_plan(3, devices=CPU4[:2]), **kw)
    with pytest.raises(ValueError, match="dict_shards=1"):
        StreamCoalescer(plan=make_encode_plan(2, devices=CPU4,
                                              dict_shards=2),
                        adaptive=True, **kw)


# -------------------------------------------------- adaptive with a plan
SEL = dict(warmup_blocks=4, patience=2, min_dwell_blocks=16)


def _signals(C, n, seed=0):
    """Heterogeneous channels: noise (stays std), trend (switches to
    delta), smooth (switches) -- rotated over C channels."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    base = [rng.normal(0.0, 1.0, n),
            0.03 * t + rng.normal(0, 0.02, n),
            np.sin(t * 0.02) * 4 + rng.normal(0, 0.01, n)]
    return np.stack([base[ci % 3] for ci in range(C)])


def _adaptive(codec, data, feed, plan=None):
    s = codec.session(channels=data.shape[0], plan=plan)
    segs = [s.feed(data[:, lo:lo + feed])
            for lo in range(0, data.shape[1], feed)]
    segs.append(s.finish())
    return segs, s


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_planned_adaptive_matches_unplanned(backend, monkeypatch):
    """An adaptive session through a 2-shard channel plan (3 channels, one
    pad lane): the unplanned session's bytes and the reference's; the
    cohort is pinned to the plan; one mixed scan a shard a feed."""
    B = 16
    data = _signals(3, B * 30, seed=8)
    kw = dict(mode="std", block_size=B, num_dict=8, adaptive=True)
    plan = make_encode_plan(3, block_size=B,
                            devices=CPU4[:2]).validate_adaptive()
    codec = IdealemCodec(backend=backend, device="cpu",
                         selector=SelectorConfig(**SEL), **kw)
    a, _ = _adaptive(codec, data, 120)
    calls = []
    real = tenc.encode_decisions_mixed

    def spy(blocks, **k):
        calls.append(tuple(blocks.shape[:1]))
        return real(blocks, **k)

    monkeypatch.setattr(tenc, "encode_decisions_mixed", spy)
    b, sb = _adaptive(codec, data, 120, plan=plan)
    assert a == b
    assert sb._mixed is not None and sb._mixed.plan is plan
    assert sb._mixed.capacity == 4 and any(st.mode_switches
                                           for st in sb.stats)
    assert calls == [(2,)] * (2 * sb._mixed.dispatches)
    with pytest.raises(ValueError, match="cannot grow"):
        sb._mixed.grow(8)
    j, _ = _adaptive(JaxCodec(backend="jax",
                              selector=JaxSelectorConfig(**SEL), **kw),
                     data, 120)
    assert a == j


def test_dict_sharded_plan_rejected_for_adaptive():
    B = 16
    plan = make_encode_plan(2, block_size=B, devices=CPU4[:2])._replace(
        dict_shards=2)
    with pytest.raises(ValueError, match="dict_shards=1"):
        plan.validate_adaptive()
    codec = IdealemCodec(mode="std", block_size=B, num_dict=8,
                         backend="torch", device="cpu", adaptive=True)
    with pytest.raises(ValueError, match="dict_shards=1"):
        codec.session(channels=2, plan=plan)


def test_planned_adaptive_coalescer_matches_unplanned():
    """The adaptive coalescer with a 4-shard plan: the bytes of the
    unplanned adaptive coalescer of the same capacity."""
    B = 16
    data = _signals(4, B * 40, seed=3)
    signals = {f"s{i}": data[i] for i in range(4)}
    steps = {sid: 90 + 31 * i for i, sid in enumerate(signals)}
    kw = dict(mode="std", block_size=B, num_dict=8, adaptive=True,
              selector=SelectorConfig(**SEL), backend="cuda", device="cpu",
              policy=FlushPolicy(max_batch_streams=4))
    plan = make_encode_plan(4, block_size=B, devices=CPU4)
    got = _drive(StreamCoalescer(plan=plan, **kw), signals, steps)
    want = _drive(StreamCoalescer(capacity=4, **kw), signals, steps)
    assert got == want


def test_reset_channel_reaches_every_dictionary_shard():
    st = tenc.init_sharded_state(5, 4, [["cpu"] * 2] * 2, channels=4)
    for row in st.grid:
        for s in row:
            s.valid.fill_(True)
            s.count.fill_(9)
    tenc.reset_channel(st, 3)
    joined = tenc.join_state(st)
    assert not joined.valid[3].any() and int(joined.count[3]) == 0
    assert joined.valid[:3].all() and (joined.count[:3] == 9).all()
    assert joined.sorted_blocks.shape == (4, 5, 4)
    assert [s.sorted_blocks.shape[1] for s in st.grid[0]] == [3, 3]
