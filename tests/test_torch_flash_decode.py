"""K4's plain version (``repro_torch.kernels.flash_decode.flash_decode_torch``)
against the reference's ``flash_decode_pallas`` (interpret mode, as
``tests/test_flash_decode_kernel.py`` runs it) and its jnp oracle
``flash_decode_ref``, on the same numpy-seeded inputs.

Tolerance 1e-5 absolute at float32 and bfloat16 caches: all three
compute in float32 and differ only in the order of their sums (measured
here: at most 7.3e-6, on the JAX test's unscaled queries at hd=64,
C=2048).  The kernel itself is held against this plain version on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.flash_decode import flash_decode_pallas  # noqa: E402
from repro.kernels.ref import flash_decode_ref  # noqa: E402
from repro_torch.kernels import flash_decode as k4  # noqa: E402
from repro_torch.models.attention import ring_valid  # noqa: E402

TOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _case(B, H, Hkv, hd, C, seed=0):
    """The JAX test's inputs: q, k, v standard normal, about 70 % of the
    positions valid, position 0 always valid."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, C, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, C, Hkv, hd)).astype(np.float32)
    valid = rng.random((B, C)) > 0.3
    valid[:, 0] = True
    return q, k, v, valid


def _both(q, k, v, valid, dtype):
    """(jax operands, torch operands): the caches rounded to ``dtype`` once,
    so both sides read the same values."""
    jdt, tdt = DTYPES[dtype]
    kj, vj = jnp.asarray(k, jdt), jnp.asarray(v, jdt)
    kt = torch.from_numpy(np.array(kj.astype(jnp.float32))).to(tdt)
    vt = torch.from_numpy(np.array(vj.astype(jnp.float32))).to(tdt)
    return ((jnp.asarray(q), kj, vj, jnp.asarray(valid)),
            (torch.from_numpy(q), kt, vt, torch.from_numpy(valid)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,H,Hkv,hd,C", [
    (2, 8, 2, 16, 1024),   # GQA group 4
    (1, 4, 4, 32, 512),    # MHA
    (3, 16, 8, 64, 2048),  # multi-chunk sweep
    (2, 6, 6, 64, 512),    # whisper-like head count
])
def test_plain_matches_pallas_and_ref(B, H, Hkv, hd, C, dtype):
    jx, tx = _both(*_case(B, H, Hkv, hd, C), dtype)
    got = k4.flash_decode_torch(*tx).numpy()
    assert got.dtype == np.float32 and got.shape == (B, H, hd)
    np.testing.assert_allclose(got, np.asarray(flash_decode_pallas(*jx)),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got, np.asarray(flash_decode_ref(*jx)),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_window_masking_matches_pallas(dtype):
    """The JAX test's window case: the cache masked to a window in
    ``valid``."""
    B, H, Hkv, hd, C = 1, 4, 2, 16, 512
    q, k, v, _ = _case(B, H, Hkv, hd, C, seed=3)
    pos = np.arange(C)
    valid = ((pos <= 400) & (400 - pos < 128))[None, :]
    jx, tx = _both(q, k, v, valid, dtype)
    got = k4.flash_decode_torch(*tx).numpy()
    np.testing.assert_allclose(got, np.asarray(flash_decode_pallas(*jx)),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("C", [1, 33, 700])
def test_any_cache_length_matches_ref(C):
    """C not a multiple of the Pallas kernel's 512-position chunk (which
    that kernel does not take): against the jnp oracle only."""
    for dtype in DTYPES:
        jx, tx = _both(*_case(2, 8, 2, 32, C, seed=C), dtype)
        np.testing.assert_allclose(k4.flash_decode_torch(*tx).numpy(),
                                   np.asarray(flash_decode_ref(*jx)),
                                   rtol=0, atol=TOL)


def test_all_masked_row_gives_mean_of_v():
    """-1e30, not -inf: a row with no valid position averages V, as the
    reference's softmax over equal scores does, and is never NaN."""
    q, k, v, valid = _case(2, 8, 2, 16, 96, seed=5)
    valid[1] = False
    jx, tx = _both(q, k, v, valid, "float32")
    got = k4.flash_decode_torch(*tx).numpy()
    mean_v = np.repeat(v[1].mean(axis=0), 4, axis=0)  # (H, hd)
    np.testing.assert_allclose(got[1], mean_v, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, np.asarray(flash_decode_ref(*jx)),
                               rtol=0, atol=TOL)


def test_wrapper_runs_plain_version_on_cpu():
    _, tx = _both(*_case(2, 8, 2, 16, 64), "bfloat16")
    before = k4.launches
    assert torch.equal(k4.flash_decode(*tx), k4.flash_decode_torch(*tx))
    assert k4.launches == before


@pytest.mark.parametrize("C,window", [(8, None), (8, 3), (5, None), (16, 4)])
def test_ring_valid_marks_the_attended_positions(C, window):
    """Slot i is valid at ``pos`` iff it holds an absolute position a with
    a % C == i, 0 <= a <= pos, and (windowed) pos - a < window."""
    for pos in range(3 * C):
        span = min(C, window or C)
        want = np.zeros(C, dtype=bool)
        for a in range(max(0, pos - span + 1), pos + 1):
            want[a % C] = True
        assert ring_valid(pos, C, window).numpy().tolist() == want.tolist()
