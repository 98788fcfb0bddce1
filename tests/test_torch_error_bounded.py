"""The error-bounded mode: PyTorch port vs the JAX reference, on the CPU.

With ``error_bound=t`` every decoded sample differs from its original by at
most ``t`` (circular distance when ``value_range`` wraps): would-be hits
whose stored raw row breaks the bound become misses and FLAG_EB decode
skips the hit permutation.  Tolerances: stream bytes identical to the JAX
codec's (port numpy vs JAX numpy, which gates in float64; port torch/cuda,
either matcher, vs JAX jax and pallas, which gate in float32); K1's plain
step identical to the Pallas kernel step by step, carry included; the
bound held on decode up to tests/test_error_bounded.py's float32 slop.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from conftest import mixed_signal  # noqa: E402
from repro.core import IdealemCodec as JaxCodec  # noqa: E402
from repro.core import encoder as jenc  # noqa: E402
from repro.kernels.dict_match import TILE_D  # noqa: E402
from repro.kernels.encode_step import (DEC_COUNT, DEC_HIT, DEC_OVER,  # noqa: E402
                                       DEC_SLOT, encode_step_pallas)
from repro_torch import IdealemCodec  # noqa: E402
from repro_torch.core import encoder as tenc  # noqa: E402
from repro_torch.core.npref import encode_decisions_np  # noqa: E402
from repro_torch.kernels import encode_step as k1  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

_F32_SLOP = 1e-4  # tests/test_error_bounded.py:25
MODES = [("std", None), ("residual", (-12.0, 12.0)), ("delta", None)]


def _err(x, y, value_range=None):
    d = np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64))
    if value_range is not None:
        w = value_range[1] - value_range[0]
        d = np.minimum(d, w - d)
    return float(np.max(d)) if len(d) else 0.0


def _kw(mode, value_range, **extra):
    return dict(mode=mode, block_size=16, num_dict=32, alpha=0.05,
                value_range=value_range, **extra)


def _port(backend, matcher=None, **kw):
    return IdealemCodec(backend=backend, matcher=matcher, device="cpu",
                        decode_backend="numpy", **kw)


@pytest.mark.parametrize("mode,value_range", MODES)
@pytest.mark.parametrize("bound", [0.05, 0.5, 2.5])
def test_bytes_equal_jax_codec_and_bound_holds(mode, value_range, bound):
    x = mixed_signal(16 * 60 + 3, seed=1)
    kw = _kw(mode, value_range, error_bound=bound)
    jax_f32 = JaxCodec(backend="jax", **kw).encode(x)
    assert JaxCodec(backend="pallas", **kw).encode(x) == jax_f32
    jax_f64 = JaxCodec(backend="numpy", **kw).encode(x)
    assert _port("numpy", **kw).encode(x) == jax_f64
    for backend, matcher in (("torch", None), ("torch", "ops"),
                             ("cuda", None), ("cuda", "ops")):
        codec = _port(backend, matcher, **kw)
        blob = codec.encode(x)
        assert blob == jax_f32, (backend, matcher)
        y = codec.decode(blob)
        assert _err(x, y, value_range) <= bound + _F32_SLOP * max(bound, 1.0)
        assert codec.decode(blob, backend="torch").tobytes() == y.tobytes()


@pytest.mark.parametrize("mode", ["residual", "delta"])
def test_relative_bound_matches_jax(mode):
    x = np.mod(mixed_signal(16 * 50, seed=4) * 40.0, 360.0)
    kw = _kw(mode, (0.0, 360.0), error_bound_rel=0.01)
    codec = _port("cuda", **kw)
    assert codec.error_bound == pytest.approx(3.6)
    blob = codec.encode(x)
    assert blob == JaxCodec(backend="jax", **kw).encode(x)
    assert _err(x, codec.decode(blob), (0.0, 360.0)) <= 3.6 + _F32_SLOP * 3.6


def test_chunked_session_equals_jax_session():
    x = mixed_signal(16 * 70 + 5, seed=6)
    kw = _kw("delta", None, error_bound=0.5)
    segs = {}
    for name, codec in (("jax", JaxCodec(backend="jax", **kw)),
                        ("port", _port("cuda", **kw))):
        s = codec.session()
        segs[name] = [s.feed(x[lo:lo + 211]) for lo in range(0, len(x), 211)]
        segs[name].append(s.finish())
    assert segs["port"] == segs["jax"]


@pytest.mark.parametrize("num_dict", [1, TILE_D + 1, 32])
@pytest.mark.parametrize("cumulative", [False, True])
def test_plain_step_matches_pallas_kernel(num_dict, cumulative):
    """K1's plain version with the raw operand, step by step against
    ``encode_step_pallas(raw=..., error_bound=..., error_cumulative=...)``
    in interpret mode: decisions, sorted and raw rows, extremes, count."""
    n, nb = 15, 40
    raw = mixed_signal(nb * n, seed=num_dict).reshape(nb, n).astype(
        np.float32)
    blocks = np.sort(raw, axis=1)
    bvalid = np.ones(nb, dtype=bool)
    bvalid[7] = False
    bound = 3.0 if cumulative else 2.5  # both hits and demotions occur
    kw = dict(d_crit=(int(0.4 * n) + 0.5) / n, rel_tol=0.5)
    dp = -(-num_dict // TILE_D) * TILE_D
    sb = rb = jnp.zeros((dp, n), jnp.float32)
    dmin = dmax = jnp.zeros((dp,), jnp.float32)
    valid = jnp.zeros((dp,), bool)
    count = jnp.int32(0)
    st = tenc.init_state(num_dict, n, channels=1, device="cpu", raw=True)
    hits = demoted = 0
    for i in range(nb):
        sb, dmin, dmax, valid, rb, dec = encode_step_pallas(
            jnp.asarray(blocks[i]), sb, dmin, dmax, valid, count,
            jnp.asarray(bvalid[i]), num_dict=num_dict, interpret=True,
            raw=jnp.asarray(raw[i]), raw_blocks=rb, error_bound=bound,
            error_cumulative=cumulative, **kw)
        count = dec[DEC_COUNT]
        free, _ = k1.encode_step_torch(
            torch.from_numpy(blocks[i][None]),
            torch.from_numpy(bvalid[i:i + 1]), st, **kw)
        st, (h, s, o) = k1.encode_step_torch(
            torch.from_numpy(blocks[i][None]),
            torch.from_numpy(bvalid[i:i + 1]), st,
            raw=torch.from_numpy(raw[i][None]), error_bound=bound,
            error_cumulative=cumulative, **kw)
        dec = np.asarray(dec)
        assert (bool(dec[DEC_HIT]), int(dec[DEC_SLOT]),
                bool(dec[DEC_OVER])) == (bool(h[0]), int(s[0]), bool(o[0]))
        assert int(dec[DEC_COUNT]) == int(st.count[0])
        for j, t in ((sb, st.sorted_blocks), (rb, st.raw_blocks),
                     (dmin, st.dmin), (dmax, st.dmax), (valid, st.valid)):
            np.testing.assert_array_equal(np.asarray(j)[:num_dict],
                                          t[0].numpy())
        hits += int(h[0])
        demoted += int(free.count[0]) < int(st.count[0])
    assert hits > 0 and demoted > 0


@pytest.mark.parametrize("cumulative", [False, True])
def test_scans_match_jax_and_numpy(cumulative):
    C, nb, n = 3, 40, 15
    blocks = np.stack([mixed_signal(nb * n, seed=10 + c).reshape(nb, n)
                       for c in range(C)]).astype(np.float32)
    valid = np.ones((C, nb), dtype=bool)
    valid[2, ::3] = False
    kw = dict(num_dict=9, d_crit=0.45, rel_tol=0.5, error_bound=1.5,
              error_cumulative=cumulative)
    want, jstate = jenc.encode_decisions_batched(
        jnp.asarray(blocks), valid=jnp.asarray(valid),
        state=jenc.init_state(9, n, channels=C, raw=True), **kw)
    for matcher in (None, "ops", "fused"):
        got, tstate = tenc.encode_decisions_batched(
            torch.from_numpy(blocks), valid=torch.from_numpy(valid),
            state=tenc.init_state(9, n, channels=C, device="cpu", raw=True),
            matcher=matcher, **kw)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
        for f in jenc.DictState._fields:
            np.testing.assert_array_equal(np.asarray(getattr(jstate, f)),
                                          getattr(tstate, f).numpy())
    np_want = encode_decisions_np(blocks[0], **kw)
    for w, g in zip(np_want, want):
        np.testing.assert_array_equal(w, np.asarray(g)[0])


@pytest.mark.parametrize("matcher", [None, "ops", "fused"])
def test_jax_error_bounded_carry_resumes_in_port(matcher):
    n, D = 15, 9
    blocks = mixed_signal(60 * n, seed=11).reshape(60, n).astype(np.float32)
    kw = dict(num_dict=D, d_crit=0.45, rel_tol=0.5, error_bound=0.8,
              error_cumulative=True)
    want, jfull = jenc.encode_decisions(
        jnp.asarray(blocks), state=jenc.init_state(D, n, raw=True), **kw)
    _, jhalf = jenc.encode_decisions(
        jnp.asarray(blocks[:25]), state=jenc.init_state(D, n, raw=True),
        **kw)
    carry = jenc.DictState(*(np.asarray(f) for f in jhalf))
    got, tstate = tenc.encode_decisions(
        torch.from_numpy(blocks[25:]),
        state=tenc.state_from_numpy(carry, device="cpu"), matcher=matcher,
        **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w)[25:], g.numpy())
    np.testing.assert_array_equal(np.asarray(jfull.raw_blocks),
                                  tstate.raw_blocks.numpy())


def test_port_error_bounded_carry_resumes_in_jax():
    n, D = 15, 7
    blocks = mixed_signal(48 * n, seed=13).reshape(48, n).astype(np.float32)
    kw = dict(num_dict=D, d_crit=0.45, rel_tol=0.5, error_bound=0.8)
    want = jenc.encode_decisions(jnp.asarray(blocks), **kw)
    _, thalf = tenc.encode_decisions(
        torch.from_numpy(blocks[:20]),
        state=tenc.init_state(D, n, device="cpu", raw=True),
        matcher="fused", **kw)
    jstate = jenc.DictState(**{k: jnp.asarray(v) for k, v in
                               tenc.state_to_numpy(thalf).items()})
    got, _ = jenc.encode_decisions(jnp.asarray(blocks[20:]), state=jstate,
                                   **kw)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w)[20:], np.asarray(g))


def test_error_bound_needs_raw_carry():
    with pytest.raises(ValueError, match="raw=True"):
        tenc.encode_decisions(
            torch.zeros((4, 8)), num_dict=3, d_crit=0.4, error_bound=1.0,
            state=tenc.init_state(3, 8, device="cpu"))


def test_error_bound_validation():
    """The validation of tests/test_error_bounded.py:98."""
    with pytest.raises(ValueError, match="positive"):
        IdealemCodec(mode="std", error_bound=-1.0, device="cpu")
    with pytest.raises(ValueError, match="value_range"):
        IdealemCodec(mode="std", error_bound_rel=0.01, device="cpu")
    c = IdealemCodec(mode="residual", value_range=(0.0, 10.0),
                     error_bound_rel=0.05, device="cpu")
    assert c.error_bound == pytest.approx(0.5)


@pytest.mark.parametrize("rel", [5e-4, 3e-4])
def test_angle_delta_at_paper_width_matches_jax(rel):
    """The paper's ANG_delta shape (B=112, so n=111) on synthetic phase
    angles: bytes equal the JAX codec's.  At this width XLA's CPU cumsum
    does not add left to right (the port does, as ``np.cumsum``), so the
    running sums may differ in the last bit; no decision differs here."""
    from repro_torch.data.synthetic import pmu_angle
    x = pmu_angle(112 * 140 + 9, slope=0.72, noise=0.06, seed=3)
    kw = dict(mode="delta", block_size=112, num_dict=255, alpha=0.01,
              rel_tol=0.5, value_range=(0.0, 360.0), error_bound_rel=rel)
    want = JaxCodec(backend="jax", **kw).encode(x)
    for backend in ("torch", "cuda"):
        assert _port(backend, **kw).encode(x) == want


def test_cumulative_gate_adds_left_to_right():
    """The plain error gate's running sum is ``np.cumsum``'s, bit for bit
    (one column at a time in the carry's dtype)."""
    rng = np.random.default_rng(8)
    raw = rng.normal(0, 0.05, (3, 111)).astype(np.float32)
    rows = rng.normal(0, 0.05, (3, 40, 111)).astype(np.float32)
    diff = np.cumsum(raw[:, None, :] - rows, axis=-1)
    bound = np.abs(diff).max(-1)[0, 7]  # one row's own running maximum
    want = (np.abs(diff) <= bound).all(-1)
    got = ref.error_gate(torch.from_numpy(raw), torch.from_numpy(rows),
                           float(bound), cumulative=True)
    np.testing.assert_array_equal(got.numpy(), want)
    # on the bound itself: the row whose running maximum is the bound passes
    on = np.abs(diff).max(-1) == bound
    assert on.any() and got.numpy()[on].all()
