"""K3 (dict_match): the port's ``ops.dict_match`` against the JAX package's
``dict_match`` (the Pallas kernel in interpret mode) and its plain jnp
oracle ``repro.kernels.ref.dict_match_ref``, on the CPU.

On the CPU the port's wrapper runs its plain version, which repeats the
CUDA kernel's arithmetic (each product and difference rounded in float32,
``inv_n = f32(1/n)``).  Tolerances:

* against the jnp oracle, which rounds op by op as well: ks bitwise equal,
  mm equal;
* against the Pallas kernel in interpret mode: mm equal, ks within 2**-24.
  XLA's CPU compiler contracts ``a * inv_n - b * inv_n`` into a fused
  multiply-add inside the kernel's fused loop, which skips one product's
  rounding (<= 2**-25 for terms <= 1) and may move the final rounding by
  one ulp of a result < 1 (<= 2**-25).  Which product it fuses differs
  from shape to shape (and between a vector loop and its remainder), so
  the test holds each row's ks to the values the three roundings of each
  term allow (:func:`_contracted_ks_bounds`), and the port to the
  op-by-op one of them;
* against ``repro.core.ks.ks_statistic_many`` (sorted rows; gaps formed as
  quotients ``k / n``): ks within 2**-22, since each of the two terms may
  round differently by up to 2**-24 and their difference once more.

KS distances are multiples of 1/n and ``critical_distance`` never sits on
one, so none of these differences moves a decision.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.ks import ks_statistic_many  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import dict_match_ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

SWEEP_D = [1, 7, 8, 9, 255]
SWEEP_N = [7, 32, 111, 256]


def _case(D, n, seed):
    """A sorted candidate and D rows in stored (unsorted) order; row 0 is
    a permutation of the candidate, so its distance is 0."""
    rng = np.random.default_rng(seed)
    xs = np.sort(rng.normal(size=n)).astype(np.float32)
    ds = rng.normal(size=(D, n)).astype(np.float32)
    ds[0] = rng.permutation(xs)
    return xs, ds, ds.min(axis=1), ds.max(axis=1)


def _contracted_ks_bounds(xs, ds):
    """Per row, ``(op_by_op, lo, hi, values)``: the ks of op-by-op float32
    rounding, and what the kernel may give when each term
    ``a * inv_n - b * inv_n`` rounds op by op or with either product fused
    into the subtraction (an FMA): its maximum lies in ``[lo, hi]`` and is
    one of the terms' ``values``.  Emulated in float64, which holds every
    product (integer <= 256 times a float32) and difference here exactly."""
    n = xs.shape[0]
    inv = np.float64(np.float32(1.0 / n))
    f64 = np.float64

    def r(v):
        return v.astype(np.float32).astype(f64)

    def variants(a, b):  # (3, D, n): op by op, a*inv fused, b*inv fused
        return np.abs(np.stack([r(r(a * inv) - r(b * inv)),
                                r(a * inv - r(b * inv)),
                                r(r(a * inv) - b * inv)]))

    t1 = variants(np.arange(1, n + 1, dtype=f64)[None, :],
                  (ds[:, :, None] <= xs).sum(1).astype(f64))
    t2 = variants((xs <= ds[:, :, None]).sum(2).astype(f64),
                  (ds[:, None, :] <= ds[:, :, None]).sum(2).astype(f64))
    t = np.concatenate([t1, t2], axis=-1)          # (3, D, 2n)
    return (t[0].max(-1), t.min(0).max(-1), t.max(0).max(-1),
            t.transpose(1, 0, 2).reshape(len(ds), -1))


def _port(xs, ds, dmin, dmax, r, dtype=torch.float32):
    ks, mm = ops.dict_match(*(torch.from_numpy(a).to(dtype)
                              for a in (xs, ds, dmin, dmax)), r)
    return ks.numpy(), mm.numpy()


def _jax(fn, xs, ds, dmin, dmax, r, dtype=jnp.float32):
    ks, mm = fn(*(jnp.asarray(a, dtype=dtype) for a in (xs, ds, dmin, dmax)),
                r)
    return np.asarray(ks), np.asarray(mm)


@pytest.mark.parametrize("D", SWEEP_D)
@pytest.mark.parametrize("n", SWEEP_N)
def test_matches_jax_oracle_and_pallas_kernel(D, n):
    args = (*_case(D, n, seed=D * 1000 + n), 0.3)
    ks, mm = _port(*args)
    ks_o, mm_o = _jax(jref, *args)
    assert ks.tobytes() == ks_o.tobytes()
    np.testing.assert_array_equal(mm, mm_o)
    ks_k, mm_k = _jax(jops.dict_match, *args)
    np.testing.assert_array_equal(mm, mm_k)
    np.testing.assert_allclose(ks, ks_k, rtol=0, atol=2.0 ** -24)
    # the gap to the kernel is XLA's contraction, not the port's arithmetic
    op_by_op, lo, hi, values = _contracted_ks_bounds(args[0], args[1])
    np.testing.assert_array_equal(ks.astype(np.float64), op_by_op)
    k64 = ks_k.astype(np.float64)
    assert np.all(lo <= k64) and np.all(k64 <= hi)
    assert all(k in v for k, v in zip(k64, values))
    assert ks.shape == mm.shape == (D,) and ks[0] == 0.0


# float64: the data are float32 values, exact in float64, and JAX runs
# without x64 here, so its side stays float32
@pytest.mark.parametrize("tdtype,jdtype", [(torch.float16, jnp.float16),
                                           (torch.bfloat16, jnp.bfloat16),
                                           (torch.float64, jnp.float32)])
def test_low_and_high_precision_operands_cast_to_f32(tdtype, jdtype):
    args = (*_case(16, 64, seed=3), 0.3)
    ks, mm = _port(*args, dtype=tdtype)
    ks_o, mm_o = _jax(jref, *args, dtype=jdtype)
    assert ks.dtype == np.float32
    assert ks.tobytes() == ks_o.tobytes()
    np.testing.assert_array_equal(mm, mm_o)


def test_gate_boundary():
    """mm exactly at the eq. (3) boundary (tests/test_kernels.py:86): both
    sides compute t = (dmax - dmin) * r in f32, so extremes landing on
    dmin/dmax -+ t pass and beyond them fail, identically."""
    n = 32
    xs = np.linspace(0.0, 1.0, n, dtype=np.float32)
    base = np.tile(xs[None, :], (6, 1))
    r = np.float32(0.25)
    t = (base[:, -1] - base[:, 0]) * r
    shift = np.asarray([0.0, 1.0, -1.0, 1.0001, 0.5, 2.0],
                       dtype=np.float32)[:, None] * t[:, None]
    ds = base + shift
    args = (xs, ds, ds.min(axis=1), ds.max(axis=1), float(r))
    ks, mm = _port(*args)
    ks_o, mm_o = _jax(jref, *args)
    np.testing.assert_array_equal(mm, mm_o)
    assert ks.tobytes() == ks_o.tobytes()
    assert mm[0] and mm[1] and mm[2]       # on-edge pass
    assert not mm[3] and not mm[5]          # outside fail


@pytest.mark.parametrize("seed", [5, 6])
def test_independent_of_stored_order(seed):
    """Counting is order-free: shuffling each row's samples changes
    neither ks (bitwise) nor mm (tests/test_kernels.py:108)."""
    rng = np.random.default_rng(seed)
    xs, ds, dmin, dmax = _case(24, 64, seed=seed)
    shuffled = np.stack([rng.permutation(row) for row in ds])
    a = _port(xs, ds, dmin, dmax, 0.4)
    b = _port(xs, shuffled, dmin, dmax, 0.4)
    assert a[0].tobytes() == b[0].tobytes()
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("D,n", [(1, 4), (13, 33), (40, 96)])
def test_identical_blocks_at_distance_zero(D, n):
    rng = np.random.default_rng(D + n)
    xs = np.sort(rng.normal(size=n)).astype(np.float32)
    ds = np.stack([rng.permutation(xs) for _ in range(D)])
    ks, mm = _port(xs, ds, ds.min(axis=1), ds.max(axis=1), 0.1)
    assert not ks.any() and mm.all()


@pytest.mark.parametrize("D", SWEEP_D)
@pytest.mark.parametrize("n", SWEEP_N)
def test_sorted_rows_match_k1_arithmetic_and_core_ks(D, n):
    """On sorted rows (how the encoder stores them) K3 gives K1's plain KS
    bitwise, and the reference's searchsorted KS to within 2**-22."""
    xs, ds, _, _ = _case(D, n, seed=D + 7 * n)
    ds = np.sort(ds, axis=1)
    txs, tds = torch.from_numpy(xs), torch.from_numpy(ds)
    ks = ops.dict_match_ks(txs, tds)
    k1 = ref.ks_counts(txs[None], tds[None], float(np.float32(1.0 / n)))[0]
    assert torch.equal(ks, k1)
    core = np.asarray(ks_statistic_many(jnp.asarray(xs), jnp.asarray(ds)))
    np.testing.assert_allclose(ks.numpy(), core, rtol=0, atol=2.0 ** -22)


def test_batched_equals_per_channel():
    """The channel axis is a batch: (C, n) x (C, D, n) equals C unbatched
    calls."""
    cases = [_case(9, 24, seed=s) for s in range(3)]
    stacked = [torch.from_numpy(np.stack(a)) for a in zip(*cases)]
    ks, mm = ops.dict_match(*stacked, 0.3)
    for c, case in enumerate(cases):
        ks_c, mm_c = _port(*case, 0.3)
        assert ks[c].numpy().tobytes() == ks_c.tobytes()
        np.testing.assert_array_equal(mm[c].numpy(), mm_c)
    ks_r, mm_r = ops.dict_match_reference(*stacked, 0.3)
    assert torch.equal(ks, ks_r) and torch.equal(mm, mm_r)
