"""K2 (the sequential row cumsum of the delta decode) on the CPU.

The wrapper runs the plain version for CPU tensors.  It is held bitwise
against ``np.cumsum(x, axis=1)``, the host decode's cumsum, in f64, f32 and
f16 with a leading -0.0 (no tolerance: the device and host decodes must
give the same bytes).  The TPU kernel cannot run on the installed jax
(``pl.load``), so numpy is the reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import seq_cumsum as k2  # noqa: E402

DTYPES = [np.float64, np.float32, np.float16]


def _rows(R, P, dtype, seed=0):
    rng = np.random.default_rng(seed)
    # wide dynamic range so the last bit of every add matters
    x = rng.normal(0, 3, (R, P)) * 10.0 ** rng.integers(-3, 3, (R, 1))
    x = x.astype(dtype)
    x[:, 0] = -0.0
    x[1, :] = -0.0  # an all-negative-zero row stays -0.0 everywhere
    return x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R,P", [(1, 1), (5, 2), (64, 111), (33, 255)])
def test_plain_cumsum_bitwise_equals_numpy(dtype, R, P):
    x = _rows(max(R, 2), P, dtype, seed=P)[:R]
    want = np.cumsum(x, axis=1)
    for fn in (k2.seq_cumsum, k2.seq_cumsum_torch):
        got = fn(torch.from_numpy(x)).numpy()
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", DTYPES)
def test_leading_negative_zero_survives(dtype):
    x = _rows(4, 9, dtype)
    got = k2.seq_cumsum(torch.from_numpy(x)).numpy()
    assert np.all(np.signbit(got[:, 0]))
    assert np.all(np.signbit(got[1]))


def test_cpu_path_does_not_launch():
    before = k2.launches
    k2.seq_cumsum(torch.zeros((3, 4)))
    assert k2.launches == before


def test_empty_shapes():
    for shape in [(0, 5), (4, 0)]:
        assert k2.seq_cumsum(torch.zeros(shape)).shape == shape
