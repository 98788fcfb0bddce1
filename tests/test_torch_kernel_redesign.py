"""The arithmetic of K4's split-and-combine and of K1's binary-search KS
counts, emulated in PyTorch on the CPU.

K4 (``csrc/flash_decode.cu``) cuts the cache axis into runs of 64-position
tiles, one run a CTA; each run keeps an online softmax (m, l, unnormalised
acc) and a second kernel merges the runs: M = max m_s, out =
sum e^(m_s - M) acc_s / max(sum e^(m_s - M) l_s, 1e-30).  The emulation
below does the same in float32 and is held within 1e-6 of the plain
version (``flash_decode_torch``) and of the JAX package's
``flash_decode_ref``: all three compute in float32 and differ only in the
order of their sums, on queries scaled by hd**-0.5 as ``decode_attention``
passes them.

K1 (``csrc/encode_step.cu``) counts #{d <= x_j}, #{x <= d_j} and
#{d <= d_j} by a binary search with the ``<=`` predicate over sorted rows
(NaNs last).  The emulation repeats its probe order and is held bitwise
against the broadcast counts and the KS values of ``ref.ks_counts``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.ref import flash_decode_ref  # noqa: E402
from repro_torch.kernels import flash_decode as k4  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models.attention import ring_valid  # noqa: E402

TILE = 64
TOL = 1e-6
MASKED = -1e30


def split_combine(q, k, v, valid, splits):
    """K4's split-and-combine in float32: ``splits`` runs of whole tiles
    (as many as give each run the same number of tiles but the last), each
    an online softmax with masked positions at -1e30, then the merge."""
    B, H, hd = q.shape
    C, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    tiles = -(-C // TILE)
    tps = -(-tiles // splits)
    qg = q.reshape(B, Hkv, G, hd).float()
    ms, ls, accs = [], [], []
    for lo in range(0, tiles * TILE, tps * TILE):
        hi = min(C, lo + tps * TILE)
        s = torch.einsum("bkgd,bckd->bkgc", qg, k[:, lo:hi].float())
        s = torch.where(valid[:, None, None, lo:hi], s, MASKED)
        m = torch.maximum(s.amax(-1), torch.tensor(MASKED))
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgc,bckd->bkgd", p, v[:, lo:hi].float()))
    assert len(ms) == -(-tiles // tps)
    m = torch.stack(ms)                       # (S, B, Hkv, G)
    M = m.amax(0)
    w = torch.exp(m - M)
    L = (w * torch.stack(ls)).sum(0)
    acc = (w[..., None] * torch.stack(accs)).sum(0)
    out = acc / torch.clamp(L, min=1e-30)[..., None]
    return out.reshape(B, H, hd)


def _case(B, H, Hkv, hd, C, seed):
    """Numpy-seeded operands: a query scaled by hd**-0.5; rows masked as a
    ring cache, plain, windowed (most splits all masked) and at random; the
    last row with no valid position."""
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, H, hd)) * hd ** -0.5).astype(np.float32)
    k = rng.normal(size=(B, C, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, C, Hkv, hd)).astype(np.float32)
    rows = [ring_valid(C + 3, C, None, "cpu"),
            ring_valid(C + 5, C, 3, "cpu"),
            torch.from_numpy(rng.random(C) > 0.3)]
    valid = torch.stack([rows[b % 3] for b in range(B)])
    valid[-1] = False
    return q, k, v, valid.numpy()


@pytest.mark.parametrize("C", [1, 33, 700])
@pytest.mark.parametrize("splits", [1, 2, 7, "per_tile"])
def test_k4_split_combine_matches_plain_and_jax(C, splits):
    B, H, Hkv, hd = 4, 8, 2, 32
    q, k, v, valid = _case(B, H, Hkv, hd, C, seed=C)
    tiles = -(-C // TILE)
    n_split = tiles if splits == "per_tile" else min(splits, tiles)
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, valid))
    got = split_combine(tq, tk, tv, tm, n_split)
    plain = k4.flash_decode_torch(tq, tk, tv, tm)
    jax_out = np.asarray(flash_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), jnp.asarray(valid)))
    assert float((got - plain).abs().max()) <= TOL
    assert float(np.abs(got.numpy() - jax_out).max()) <= TOL
    # the row with no valid position averages V over every split
    mean_v = tv[-1].mean(0).repeat_interleave(H // Hkv, dim=0)
    assert float((got[-1] - mean_v).abs().max()) <= TOL


def test_k4_all_masked_splits_weigh_nothing():
    """A split whose every position is masked has m = -1e30 and drops out
    of the merge beside a split with a valid position; a ragged last tile
    adds nothing."""
    B, H, Hkv, hd, C = 2, 4, 1, 16, 5 * TILE + 17
    q, k, v, valid = _case(B, H, Hkv, hd, C, seed=3)
    valid[:] = False
    valid[0, 2 * TILE + 5] = True              # one valid position, split 2
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, valid))
    got = split_combine(tq, tk, tv, tm, 6)
    # one valid position: its V row exactly, up to the float32 products
    want = tv[0, 2 * TILE + 5].repeat_interleave(H // Hkv, dim=0)
    assert float((got[0] - want).abs().max()) <= TOL
    assert float((got - k4.flash_decode_torch(tq, tk, tv, tm)).abs().max()) \
        <= TOL


def count_le(a, v):
    """K1's count: #{i : a[i] <= v} over sorted ``a`` (..., n) with NaNs
    last, for each ``v`` (..., m), by the kernel's probe order (steps from
    the largest power of two <= n down to 1)."""
    n = a.shape[-1]
    lo = torch.zeros(v.shape, dtype=torch.int64)
    s = 1 << (n.bit_length() - 1)
    while s:
        i = lo + s
        probe = torch.gather(a, -1, (i - 1).clamp(max=n - 1))
        lo = torch.where((i <= n) & (probe <= v), i, lo)
        s >>= 1
    return lo


def ks_binary(xs, ds, inv_n):
    """K1's KS distance of the sorted candidate ``xs`` (n,) against sorted
    rows ``ds`` (D, n): binary-search counts, ks_arith.cuh's gaps (each
    product and difference rounded in float32), the max over points."""
    D, n = ds.shape
    x = xs.expand(D, n)
    inv = torch.tensor(inv_n, dtype=torch.float32)
    cnt_d, cnt_x, rank_d = count_le(ds, x), count_le(x, ds), count_le(ds, ds)
    j1 = torch.arange(n, dtype=torch.float32) + 1.0
    d1 = torch.abs(j1 * inv - cnt_d.float() * inv)
    d2 = torch.abs(cnt_x.float() * inv - rank_d.float() * inv)
    return torch.maximum(d1.amax(-1), d2.amax(-1)), (cnt_d, cnt_x, rank_d)


def _sorted_rows(D, n, seed):
    """Sorted float32 rows with ties, -0.0 and +0.0, +-inf and NaN tails;
    row 0 is the candidate itself."""
    rng = np.random.default_rng(seed)
    a = np.round(rng.normal(size=(D + 1, n)), 1).astype(np.float32)
    a[rng.random(a.shape) < 0.1] = 0.0
    a[rng.random(a.shape) < 0.1] = -0.0
    a[rng.random(a.shape) < 0.05] = np.inf
    a[rng.random(a.shape) < 0.05] = -np.inf
    for r in range(0, D + 1, 3):
        a[r, rng.integers(0, n):] = np.nan    # a NaN tail
    t = torch.sort(torch.from_numpy(a), dim=-1).values
    t[1] = t[0]
    return t[0], t[1:]


@pytest.mark.parametrize("n", [7, 32, 111])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k1_binary_search_counts_equal_broadcast_counts(n, seed):
    x, ds = _sorted_rows(40, n, seed)
    inv_n = float(np.float32(1.0 / n))
    ks, (cnt_d, cnt_x, rank_d) = ks_binary(x, ds, inv_n)
    xb = x[None, None, :]
    dk = ds[:, :, None]
    assert torch.equal(cnt_d, (dk <= xb).sum(-2))                # #{d <= x_j}
    assert torch.equal(cnt_x, (xb <= dk).sum(-1))                # #{x <= d_k}
    assert torch.equal(rank_d, (ds[:, None, :] <= dk).sum(-1))   # #{d <= d_k}
    want = ref.ks_counts(x, ds, inv_n)
    assert torch.equal(ks.view(torch.int32), want.view(torch.int32))
    assert float(ks[0]) == 0.0 or bool(torch.isnan(x).any())


def test_k1_nan_points_count_zero():
    """A NaN point counts 0 on both sides, as the broadcast compares do,
    and -0.0 ties +0.0."""
    x = torch.tensor([-1.0, -0.0, 0.0, 2.0, math.nan, math.nan])
    d = torch.tensor([[0.0, -0.0, 1.0, math.inf, math.nan, math.nan]])
    _, (cnt_d, cnt_x, rank_d) = ks_binary(x, d, float(np.float32(1 / 6)))
    assert cnt_d.tolist() == [[0, 2, 2, 3, 0, 0]]
    assert cnt_x.tolist() == [[3, 3, 3, 4, 0, 0]]
    assert rank_d.tolist() == [[2, 2, 3, 4, 0, 0]]
