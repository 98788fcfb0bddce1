"""PyTorch port vs the JAX reference: KS machinery and range wraps.

Inputs come from numpy seeds and reach both packages as numpy arrays.
Tolerances: ``critical_distance`` is compared with ``==`` (the threshold
feeds every encode decision); ``kolmogorov_sf`` to 1e-12 in f64 (the same
40-term series, summed by two libraries); ``ks_statistic_many`` to 1 ulp
in f32 (multiples of 1/n, where a fused multiply-add may move the last
bit); the wraps bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ks as jks  # noqa: E402
from repro.core import transforms as jtr  # noqa: E402
from repro_torch.core import ks as tks  # noqa: E402
from repro_torch.core import transforms as ttr  # noqa: E402


@pytest.mark.parametrize("alpha", [0.001, 0.01, 0.05, 0.2, 0.5, 0.9])
@pytest.mark.parametrize("n", [2, 7, 16, 31, 32, 111, 255])
def test_critical_distance_identical(alpha, n):
    assert tks.critical_distance(alpha, n, n) == jks.critical_distance(
        alpha, n, n)
    assert tks.critical_distance(alpha, n, n + 3) == jks.critical_distance(
        alpha, n, n + 3)


def test_critical_distance_rejects_bad_alpha():
    for a in (0.0, 1.0, -0.1):
        with pytest.raises(ValueError):
            tks.critical_distance(a, 8, 8)


def test_kolmogorov_sf_f64():
    lam = np.concatenate([[0.0, 1e-13, 0.05, 0.0999, 0.1, 0.1001],
                          np.random.default_rng(0).uniform(0, 3, 200)])
    with jax.enable_x64(True):
        want = np.asarray(jks.kolmogorov_sf(jnp.asarray(lam)))
    got = tks.kolmogorov_sf(torch.from_numpy(lam)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert np.all(got[:4] == 1.0)  # small-lam cutoff, identical samples


def test_ks_pvalue_f64():
    d = np.random.default_rng(1).uniform(0, 0.6, 64)
    with jax.enable_x64(True):
        want = np.asarray(jks.ks_pvalue(jnp.asarray(d), 32, 32))
    got = tks.ks_pvalue(torch.from_numpy(d), 32, 32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n,D", [(7, 1), (16, 9), (32, 40), (111, 12)])
def test_ks_statistic_many_within_one_ulp(n, D):
    rng = np.random.default_rng(n)
    xs = np.sort(rng.normal(0, 1, n)).astype(np.float32)
    ds = np.sort(rng.normal(0.2, 1.1, (D, n)), axis=1).astype(np.float32)
    ds[0] = xs  # an identical row: distance exactly 0
    want = np.asarray(jks.ks_statistic_many(jnp.asarray(xs), jnp.asarray(ds)))
    got = tks.ks_statistic_many(torch.from_numpy(xs),
                                torch.from_numpy(ds)).numpy()
    assert got.dtype == np.float32 and got.shape == (D,)
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    assert got[0] == 0.0
    # batched leading axis: channel c is the unbatched call on its rows
    got_b = tks.ks_statistic_many(torch.from_numpy(np.stack([xs, xs])),
                                  torch.from_numpy(np.stack([ds, ds[::-1]])))
    np.testing.assert_array_equal(got_b[0].numpy(), got)
    np.testing.assert_array_equal(got_b[1].numpy(), got[::-1])


def _wrap_inputs(dtype):
    v = np.random.default_rng(3).normal(0, 500, 4096)
    v[:6] = [-0.0, 0.0, -360.0, 360.0, 720.0, 359.99]
    return v.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.float16])
def test_numpy_wraps_identical(dtype):
    v = _wrap_inputs(dtype)
    for fn in ("np_wrap_centered", "np_wrap_range"):
        want = getattr(jtr, fn)(v, 0.0, 360.0)
        got = getattr(ttr, fn)(v, 0.0, 360.0)
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.float16])
@pytest.mark.parametrize("rng_", [(0.0, 360.0), (-180.0, 180.0)])
def test_torch_wrap_range_bitwise(dtype, rng_):
    """The device decode's wrap equals the host decode's np.mod wrap."""
    v = _wrap_inputs(dtype)
    want = ttr.np_wrap_range(v, *rng_)
    got = ttr.wrap_range(torch.from_numpy(v), *rng_).numpy()
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def test_torch_wrap_range_matches_jax_f32():
    v = _wrap_inputs(np.float32)
    want = np.asarray(jtr.wrap_range(jnp.asarray(v), 0.0, 360.0))
    got = ttr.wrap_range(torch.from_numpy(v), 0.0, 360.0).numpy()
    assert got.tobytes() == want.tobytes()


# ------------------------------------------------------ KS of two samples
def _sample_pairs():
    """(x, y) pairs: equal and unequal sizes, ties, a shifted copy, NaNs
    (sorted last by both libraries)."""
    rng = np.random.default_rng(7)
    a = rng.normal(0, 1, 32).astype(np.float32)
    ties = np.round(rng.normal(0, 1, 40), 1).astype(np.float32)
    nan = a.copy()
    nan[[3, 11]] = np.nan
    return [(a, rng.normal(0, 1, 32).astype(np.float32)),
            (a, rng.normal(0.3, 2, 17).astype(np.float32)),
            (ties, np.round(rng.normal(0, 1, 40), 1).astype(np.float32)),
            (a, a + np.float32(0.5)), (a, a), (nan, a)]


@pytest.mark.parametrize("case", range(6))
def test_ks_statistic_equals_reference(case):
    """``ks_statistic`` (unsorted) and ``ks_statistic_sorted`` bitwise
    against the reference's: the same float32 counts over n1 and n2."""
    x, y = _sample_pairs()[case]
    want = np.asarray(jks.ks_statistic(jnp.asarray(x), jnp.asarray(y)))
    got = tks.ks_statistic(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32
    assert got.item() == want.item()
    xs, ys = np.sort(x), np.sort(y)
    want = np.asarray(jks.ks_statistic_sorted(jnp.asarray(xs),
                                              jnp.asarray(ys)))
    got = tks.ks_statistic_sorted(torch.from_numpy(xs), torch.from_numpy(ys))
    assert got.item() == want.item()


# ------------------------------------------------- residual and delta
@pytest.mark.parametrize("value_range", [None, (0.0, 360.0)])
@pytest.mark.parametrize("mode", ["residual", "delta"])
def test_transforms_equal_reference(mode, value_range):
    """Forward transforms and their inverses, float32, against the
    reference's ``residual_/delta_forward/inverse``: bases exact,
    transformed values and reconstructions bitwise but for the delta
    inverse's cumsum, which XLA takes as a parallel prefix and torch left
    to right: within 2e-3, 4 ulps of float32 at the partial sums' largest
    magnitude (15 deltas of up to 180: under 4096)."""
    rng = np.random.default_rng(11)
    blocks = rng.uniform(0, 360, (6, 9, 16)).astype(np.float32)
    fwd = getattr(jtr, f"{mode}_forward")
    inv = getattr(jtr, f"{mode}_inverse")
    tfwd = getattr(ttr, f"{mode}_forward")
    tinv = getattr(ttr, f"{mode}_inverse")
    jb, jv = fwd(jnp.asarray(blocks), value_range)
    tb, tv = tfwd(torch.from_numpy(blocks), value_range)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    want = np.asarray(inv(jb, jv, value_range))
    got = tinv(tb, tv, value_range).numpy()
    if mode == "residual":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    if value_range is None:
        np.testing.assert_allclose(got, blocks, rtol=0, atol=1e-3)


def test_wrap_centered_equals_reference():
    v = np.random.default_rng(3).uniform(-720, 720, 4096).astype(np.float32)
    want = np.asarray(jtr.wrap_centered(jnp.asarray(v), 0.0, 360.0))
    got = ttr.wrap_centered(torch.from_numpy(v), 0.0, 360.0).numpy()
    np.testing.assert_array_equal(got, want)
