"""K1 (the fused encode step) and the encoder scan: PyTorch port vs the JAX
reference, on the CPU.

On the CPU the port's ``encode_scan`` runs its plain version, which repeats
the CUDA kernel's arithmetic.  It is held step by step against the TPU
kernel ``encode_step_pallas`` in interpret mode, and scan by scan against
``encode_decisions`` with the reference matcher.  Tolerance: decisions and
FIFO counts are equal; the carry is equal by value (``assert_array_equal``
treats -0.0 == 0.0: a tie between the two zeros may sort either way).
Thresholds sit between KS jump points (multiples of 1/n), as
``critical_distance`` thresholds always do.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import encoder as jenc  # noqa: E402
from repro.kernels.dict_match import TILE_D  # noqa: E402
from repro.kernels.encode_step import (DEC_COUNT, DEC_HIT, DEC_OVER,  # noqa: E402
                                       DEC_SLOT, encode_step_pallas)
from repro_torch.core import encoder as tenc  # noqa: E402
from repro_torch.kernels import encode_step as k1  # noqa: E402

EDGE_D = [1, TILE_D - 1, TILE_D + 1, 255]
EDGE_N = [TILE_D - 1, 24, 256]


def _mixture_blocks(nb, n, dtype=np.float32, seed=0):
    """Hits, misses and FIFO overwrites all occur on this traffic."""
    rng = np.random.default_rng(seed)
    parts = [rng.normal(m, s, size=(nb // 3, n))
             for m, s in [(0, 1), (5, 0.5), (0, 1)]]
    parts.append(rng.normal(0, 1, size=(nb - 3 * (nb // 3), n)))
    return np.concatenate(parts).astype(dtype)


def _d_crit(n):
    return (int(0.4 * n) + 0.5) / n


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _same_decisions(jax_out, torch_out):
    for x, y in zip(jax_out, torch_out):
        _eq(x, y.numpy())


def _same_carry(jstate, tstate, num_dict):
    _eq(np.asarray(jstate.sorted_blocks)[..., :num_dict, :],
        tstate.sorted_blocks.numpy())
    for f in ("dmin", "dmax", "valid"):
        _eq(np.asarray(getattr(jstate, f))[..., :num_dict],
            getattr(tstate, f).numpy())
    _eq(jstate.count, tstate.count.numpy())


# ------------------------------------------- K1 plain version vs TPU kernel
@pytest.mark.parametrize("num_dict", EDGE_D)
@pytest.mark.parametrize("n", EDGE_N)
def test_plain_step_matches_pallas_kernel(num_dict, n):
    nb = 12
    blocks = np.sort(_mixture_blocks(nb, n, seed=n + num_dict), axis=1)
    bvalid = np.ones(nb, dtype=bool)
    bvalid[5] = False  # one masked step: carry untouched, decision zero
    kw = dict(d_crit=_d_crit(n), rel_tol=0.5)
    dp = -(-num_dict // TILE_D) * TILE_D
    sb = jnp.zeros((dp, n), jnp.float32)
    dmin = dmax = jnp.zeros((dp,), jnp.float32)
    valid = jnp.zeros((dp,), bool)
    count = jnp.int32(0)
    st = tenc.init_state(num_dict, n, channels=1, device="cpu")
    for i in range(nb):
        sb, dmin, dmax, valid, dec = encode_step_pallas(
            jnp.asarray(blocks[i]), sb, dmin, dmax, valid, count,
            jnp.asarray(bvalid[i]), num_dict=num_dict, interpret=True, **kw)
        count = dec[DEC_COUNT]
        st, (h, s, o) = k1.encode_step_torch(
            torch.from_numpy(blocks[i][None]),
            torch.from_numpy(bvalid[i:i + 1]), st, **kw)
        dec = np.asarray(dec)
        assert (bool(dec[DEC_HIT]), int(dec[DEC_SLOT]),
                bool(dec[DEC_OVER])) == (bool(h[0]), int(s[0]), bool(o[0]))
        assert int(dec[DEC_COUNT]) == int(st.count[0])
        _eq(np.asarray(sb)[:num_dict], st.sorted_blocks[0].numpy())
        _eq(np.asarray(dmin)[:num_dict], st.dmin[0].numpy())
        _eq(np.asarray(dmax)[:num_dict], st.dmax[0].numpy())
        _eq(np.asarray(valid)[:num_dict], st.valid[0].numpy())


# ------------------------------------- scans vs the JAX reference matcher
@pytest.mark.parametrize("num_dict", EDGE_D)
@pytest.mark.parametrize("n", EDGE_N)
def test_scans_match_reference(num_dict, n):
    blocks = _mixture_blocks(45, n)
    kw = dict(num_dict=num_dict, d_crit=_d_crit(n), rel_tol=0.5)
    want, jstate = jenc.encode_decisions(
        jnp.asarray(blocks), state=jenc.init_state(num_dict, n), **kw)
    for matcher in (None, "fused"):
        got, tstate = tenc.encode_decisions(
            torch.from_numpy(blocks),
            state=tenc.init_state(num_dict, n, device="cpu"),
            matcher=matcher, **kw)
        _same_decisions(want, got)
        _same_carry(jstate, tstate, num_dict)


@pytest.mark.parametrize("use_minmax,use_ks",
                         [(False, True), (True, False), (False, False)])
def test_ablations_match_reference(use_minmax, use_ks):
    blocks = _mixture_blocks(40, 16, seed=5)
    kw = dict(num_dict=7, d_crit=0.4, rel_tol=0.5, use_minmax=use_minmax,
              use_ks=use_ks)
    want = jenc.encode_decisions(jnp.asarray(blocks), **kw)
    for matcher in (None, "fused"):
        _same_decisions(want, tenc.encode_decisions(
            torch.from_numpy(blocks), matcher=matcher, **kw))


def test_minmax_gate_boundary():
    """Extremes exactly on dmin - t / dmax + t pass (eq. 3 is inclusive);
    one ulp outside fails, on every path."""
    n = 16
    base = np.linspace(0.0, 1.0, n, dtype=np.float32)
    on = base.copy()
    on[0], on[-1] = -0.5, 1.5
    off = base.copy()
    off[0] = np.nextafter(np.float32(-0.5), np.float32(-1.0))
    blocks = np.stack([base, on, off])
    kw = dict(num_dict=3, d_crit=2.0, rel_tol=0.5)
    want = jenc.encode_decisions(jnp.asarray(blocks), **kw)
    for matcher in (None, "fused"):
        got = tenc.encode_decisions(torch.from_numpy(blocks),
                                    matcher=matcher, **kw)
        _same_decisions(want, got)
        assert bool(got[0][1]) and not bool(got[0][2])


@pytest.mark.parametrize("matcher", [None, "fused"])
def test_batched_ragged_matches_reference(matcher):
    C, nb, n = 3, 30, 24
    blocks = np.stack([_mixture_blocks(nb, n, seed=s) for s in range(C)])
    valid = np.ones((C, nb), dtype=bool)
    valid[1, 20:] = False
    valid[2, ::4] = False
    kw = dict(num_dict=9, d_crit=_d_crit(n), rel_tol=0.5)
    want, jstate = jenc.encode_decisions_batched(
        jnp.asarray(blocks), valid=jnp.asarray(valid),
        state=jenc.init_state(9, n, channels=C), **kw)
    got, tstate = tenc.encode_decisions_batched(
        torch.from_numpy(blocks), valid=torch.from_numpy(valid),
        state=tenc.init_state(9, n, channels=C, device="cpu"),
        matcher=matcher, **kw)
    _same_decisions(want, got)
    _same_carry(jstate, tstate, 9)
    assert not got[0][~torch.from_numpy(valid)].any()


@pytest.mark.parametrize("matcher", [None, "fused"])
def test_chunked_scan_equals_one_shot(matcher):
    blocks = torch.from_numpy(_mixture_blocks(90, 24, seed=7))
    kw = dict(num_dict=7, d_crit=0.4, rel_tol=0.5, matcher=matcher)
    want = tenc.encode_decisions(blocks, **kw)
    state = tenc.init_state(7, 24, device="cpu")
    parts = []
    for lo in range(0, 90, 17):
        out, state = tenc.encode_decisions(blocks[lo:lo + 17], state=state,
                                           **kw)
        parts.append(out)
    for i in range(3):
        _eq(want[i], torch.cat([p[i] for p in parts]))
    assert int(state.count) == int((~want[0]).sum())


# ----------------------------------------------- carry across the packages
@pytest.mark.parametrize("matcher", [None, "fused"])
def test_jax_half_scan_resumes_in_port(matcher):
    n, D = 24, 9
    blocks = _mixture_blocks(60, n, seed=11)
    kw = dict(num_dict=D, d_crit=_d_crit(n), rel_tol=0.5)
    want, jfull = jenc.encode_decisions(
        jnp.asarray(blocks), state=jenc.init_state(D, n), **kw)
    _, jhalf = jenc.encode_decisions(
        jnp.asarray(blocks[:25]), state=jenc.init_state(D, n), **kw)
    carry = jenc.DictState(*(np.asarray(f) for f in jhalf))
    got, tstate = tenc.encode_decisions(
        torch.from_numpy(blocks[25:]),
        state=tenc.state_from_numpy(carry, device="cpu"),
        matcher=matcher, **kw)
    _same_decisions(tuple(np.asarray(w)[25:] for w in want), got)
    _same_carry(jfull, tstate, D)


def test_port_half_scan_resumes_in_jax():
    n, D = 16, 7
    blocks = _mixture_blocks(48, n, seed=13)
    kw = dict(num_dict=D, d_crit=_d_crit(n), rel_tol=0.5)
    want = jenc.encode_decisions(jnp.asarray(blocks), **kw)
    _, thalf = tenc.encode_decisions(
        torch.from_numpy(blocks[:20]),
        state=tenc.init_state(D, n, device="cpu"),
        matcher="fused", **kw)
    jstate = jenc.DictState(**{k: jnp.asarray(v) for k, v in
                               tenc.state_to_numpy(thalf).items()})
    got, _ = jenc.encode_decisions(jnp.asarray(blocks[20:]), state=jstate,
                                   **kw)
    for w, g in zip(want, got):
        _eq(np.asarray(w)[20:], g)


def test_state_from_numpy_rejects_error_bounded_carry():
    """An error-bounded carry crosses over with its raw rows; one whose raw
    rows match neither the empty form nor the dictionary is rejected."""
    st = jenc.DictState(*(np.asarray(f) for f in jenc.init_state(4, 8,
                                                                  raw=True)))
    assert tuple(tenc.state_from_numpy(st, device="cpu").raw_blocks.shape) \
        == (4, 8)
    with pytest.raises(ValueError, match="raw_blocks"):
        tenc.state_from_numpy(st._replace(raw_blocks=np.zeros((3, 8))),
                              device="cpu")


def test_unported_matchers_raise():
    blocks = torch.zeros((2, 8))
    for m in ("nope", "pallas"):
        with pytest.raises(ValueError, match="unknown matcher"):
            tenc.encode_decisions(blocks, num_dict=2, d_crit=0.5, matcher=m)
