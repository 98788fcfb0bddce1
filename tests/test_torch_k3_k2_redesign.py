"""The counting order of K3 and the tile plan of K2, emulated in PyTorch
and numpy on the CPU.

K3 (``csrc/dict_match.cu``) checks by a warp ballot over adjacent pairs
whether each row (and, in every warp, the candidate) is sorted with NaNs
last; a row that is not is sorted by a bitonic network over unsigned keys
that put every NaN last whatever its sign; the searches for #{x <= d_k}
run over a sorted copy of the candidate, while d1 and the eq. 3 gate keep
the candidate's own points, indices, xs[0] and xs[n-1].  Up to n = 128,
for a sorted candidate, ``ks_padded`` counts (``csrc/ks_count.cuh``): the
arrays are padded with NaNs to a power of two np2 >= 32, each search is a
branch-free binary search from np2/2 down to 1 with one last probe at the
count, and #{d <= d_k} is k + 1 unless the next point ties.  Otherwise
``ks_warp`` counts: three binary searches stepped from the largest power
of two <= n down to 1.  The emulation repeats those steps and is held
bitwise against the port's plain version (``ref.dict_match_ref``) and the
JAX package's eager oracle, and within 2**-24 of the Pallas kernel in
interpret mode (XLA's CPU compiler contracts products into FMAs there; see
``tests/test_torch_dict_match.py``).

K2 (``csrc/seq_cumsum.cu``) copies a tile of up to 32 whole rows as one
contiguous span (its shared image shifted by the span's address modulo
16, 16-byte copies between element-wise heads and tails), walks each row
left to right at an odd row stride, and stores the tile in 16-byte stores
aligned to the output; long rows go in column chunks.  The emulation
repeats the plan and the copies' index ranges for a base with a storage
offset and shows that each element is copied in and out exactly once and
each row summed once, left to right, equal to ``np.cumsum`` bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import dict_match_ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import seq_cumsum as k2  # noqa: E402
from repro_torch.testing import NEG_NAN, k3_special  # noqa: E402

NAN_KEY = 0xFFFFFFFF


# ---------------------------------------------------------------- K3
def in_order(a, b):
    """The ballot's pair test: non-decreasing, NaNs last."""
    return (a <= b) | torch.isnan(b)


def warp_sorted(a):
    """Per row of ``a`` (..., n): every adjacent pair in order."""
    if a.shape[-1] < 2:
        return torch.ones(a.shape[:-1], dtype=torch.bool)
    return in_order(a[..., :-1], a[..., 1:]).all(-1)


def sort_key(a):
    """The kernel's keys as int64 holding the unsigned 32-bit values."""
    b = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(b >= 0x80000000, b ^ 0xFFFFFFFF, b | 0x80000000)
    return torch.where(torch.isnan(a), torch.full_like(b, NAN_KEY), key)


def from_key(k):
    b = torch.where(k >= 0x80000000, k & 0x7FFFFFFF, k ^ 0xFFFFFFFF)
    return b.to(torch.int32).view(torch.float32)  # wraps to the same bits


def warp_sort(a):
    """The bitonic network of ``warp_sort`` over rows ``a`` (..., n),
    padded with the NaN key to a power of two >= 32."""
    n = a.shape[-1]
    np2 = max(32, 1 << (n - 1).bit_length())
    u = torch.full((*a.shape[:-1], np2), NAN_KEY, dtype=torch.int64)
    u[..., :n] = sort_key(a)
    p = torch.arange(np2 // 2)
    k = 2
    while k <= np2:
        j = k >> 1
        while j > 0:
            i = ((p & ~(j - 1)) << 1) | (p & (j - 1))
            lo, hi = u[..., i], u[..., i + j]
            mn, mx = torch.minimum(lo, hi), torch.maximum(lo, hi)
            up = (i & k) == 0
            u[..., i] = torch.where(up, mn, mx)
            u[..., i + j] = torch.where(up, mx, mn)
            j >>= 1
        k <<= 1
    return from_key(u[..., :n])


def count_le(a, v):
    """#{i : a[i] <= v} over sorted ``a`` (..., n) with NaNs last, by
    ``ks_warp``'s probe order."""
    n = a.shape[-1]
    lo = torch.zeros(v.shape, dtype=torch.int64)
    s = 1 << (n.bit_length() - 1)
    while s:
        i = lo + s
        probe = torch.gather(a, -1, (i - 1).clamp(max=n - 1))
        lo = torch.where((i <= n) & (probe <= v), i, lo)
        s >>= 1
    return lo


def count_pow2(a, v):
    """``count_le<L>``: #{i : a[i] <= v} over sorted rows ``a`` (..., n)
    padded with NaNs to 2^L = max(32, a power of two >= n) words: a
    branch-free binary search from 2^(L-1) down to 1, then one last probe
    at the count."""
    n = a.shape[-1]
    np2 = max(32, 1 << (n - 1).bit_length())
    pad = torch.full((*a.shape[:-1], np2), float("nan"))
    pad[..., :n] = a
    c = torch.zeros(v.shape, dtype=torch.int64)
    s = np2 // 2
    while s:
        c = c + torch.where(torch.gather(pad, -1, c + s - 1) <= v, s, 0)
        s //= 2
    return c + (torch.gather(pad, -1, c) <= v).long()


def padded_counts(xs, d):
    """``ks_padded``'s counts for the sorted candidate ``xs`` (n,) and
    each sorted row ``d`` (D, n): #{d <= x_k} and #{x <= d_k} are padded
    searches; #{d <= d_k} is k + 1 unless the next point ties d_k (then a
    search).  Returns (cnt_d, cnt_x, rank_d), each (D, n)."""
    D, n = d.shape
    x = xs.expand(D, n).contiguous()
    k = torch.arange(n)
    cnt_d, cnt_x = count_pow2(d, x), count_pow2(x, d)
    nxt = torch.cat([d[:, 1:], torch.full((D, 1), float("nan"))], -1)
    rank_d = torch.where(nxt <= d, count_pow2(d, d), k + 1)
    rank_d = torch.where(torch.isnan(d), 0, rank_d)
    return cnt_d, cnt_x, rank_d


def k3_emulated(xs, rows, dmin, dmax, rel_tol):
    """K3's steps for one channel: xs (n,), rows (D, n) -> (ks, mm)."""
    D, n = rows.shape
    inv = torch.tensor(float(np.float32(1.0 / n)), dtype=torch.float32)
    cand_sorted = bool(warp_sorted(xs))
    xsrt = xs if cand_sorted else warp_sort(xs)
    keep = warp_sorted(rows)
    d = torch.where(keep[:, None], rows, warp_sort(rows))
    if cand_sorted and n <= 128:                 # ks_padded
        cnt_d, cnt_x, rank_d = padded_counts(xs, d)
    else:                                         # ks_warp
        xp = xs.expand(D, n)
        cnt_d = count_le(d, xp)                   # #{d <= x_j}, own order
        cnt_x = count_le(xsrt.expand(D, n), d)    # #{x <= d_k}
        rank_d = count_le(d, d)                   # #{d <= d_k}
    j1 = torch.arange(n, dtype=torch.float32) + 1.0
    d1 = torch.abs(j1 * inv - cnt_d.float() * inv)
    d2 = torch.abs(cnt_x.float() * inv - rank_d.float() * inv)
    ks = torch.maximum(d1.amax(-1), d2.amax(-1))
    r = torch.tensor(float(np.float32(rel_tol)), dtype=torch.float32)
    mm = ref.minmax_gate(xs[:1], xs[-1:], dmin, dmax, r)
    return ks, mm


def _k3_case(D, n, seed, rows_sorted, cand_sorted):
    """One channel of ``k3_special``: candidate (n,), rows (D, n) and
    their extremes (D,)."""
    return [a[0] for a in k3_special(1, D, n, seed, cand_sorted, rows_sorted)]


def test_sort_key_orders_floats_with_every_nan_last():
    vals = np.array([np.nan, -np.inf, -1.5, -0.0, 0.0, 1e-45, 2.0, np.inf,
                     NEG_NAN], dtype=np.float32)
    t = torch.from_numpy(vals)
    out = warp_sort(t)
    got = out.numpy()
    assert np.isnan(got[-2:]).all() and not np.isnan(got[:-2]).any()
    assert np.array_equal(got[:-2], np.sort(vals[~np.isnan(vals)]))
    assert bool(warp_sorted(out))
    # the ballot takes +0.0 before -0.0 as sorted; a NaN before a number not
    assert bool(warp_sorted(torch.tensor([0.0, -0.0, 1.0])))
    assert not bool(warp_sorted(torch.tensor([float("nan"), 1.0])))
    assert torch.equal(from_key(sort_key(t)).view(torch.int32)[1:-1],
                       t.view(torch.int32)[1:-1])


@pytest.mark.parametrize("n", [1, 7, 32, 33, 111, 256])
@pytest.mark.parametrize("D", [1, 9, 255])
@pytest.mark.parametrize("rows_sorted", [False, True])
def test_k3_emulation_matches_plain_jax_and_pallas(n, D, rows_sorted):
    for cand_sorted in (True, False):
        xs, rows, dmin, dmax = _k3_case(D, n, n * 1000 + D, rows_sorted,
                                        cand_sorted)
        t = [torch.from_numpy(a) for a in (xs, rows, dmin, dmax)]
        ks, mm = k3_emulated(*t, 0.3)
        ks_p, mm_p = ref.dict_match_ref(*t, 0.3)
        assert torch.equal(ks.view(torch.int32), ks_p.view(torch.int32))
        assert torch.equal(mm, mm_p)
        j = [jnp.asarray(a) for a in (xs, rows, dmin, dmax)]
        ks_j, mm_j = jref(*j, 0.3)
        assert ks.numpy().tobytes() == np.asarray(ks_j).tobytes()
        np.testing.assert_array_equal(mm.numpy(), np.asarray(mm_j))
        ks_k, mm_k = jops.dict_match(*j, 0.3)
        np.testing.assert_array_equal(mm.numpy(), np.asarray(mm_k))
        np.testing.assert_allclose(ks.numpy(), np.asarray(ks_k), rtol=0,
                                   atol=2.0 ** -24)
        if cand_sorted and len(np.unique(xs)) == n:  # no NaN, no tie
            assert float(ks[0]) == 0.0  # a permutation of the candidate


@pytest.mark.parametrize("n", [1, 7, 32, 33, 111, 128])
def test_k3_padded_counts_equal_broadcast_counts(n):
    """The padded searches' counts are the broadcast compares' integers,
    on rows with long ties (one value repeated), NaN tails and +-0.0."""
    xs, rows, _, _ = _k3_case(60, n, n, True, True)
    x, d = torch.from_numpy(xs), torch.from_numpy(rows)
    d[1] = 0.5                                    # all tied
    d[2, : n // 2] = -0.0
    d[2, n // 2:] = 0.0
    d = torch.sort(d, dim=-1).values
    cnt_d, cnt_x, rank_d = padded_counts(x, d)
    xb, dk = x[None, None, :], d[:, :, None]
    assert torch.equal(cnt_d, (dk <= xb).sum(-2))
    assert torch.equal(cnt_x, (xb <= dk).sum(-1))
    assert torch.equal(rank_d, (d[:, None, :] <= dk).sum(-1))


@pytest.mark.parametrize("n", [1, 31, 32, 64, 100, 128])
def test_k3_padded_search_reaches_every_count(n):
    """The padded search returns every count from 0 to n, n = 2^L (all
    points <= v, reached by the last probe) and the NaN point (0)
    included."""
    a = torch.sort(torch.from_numpy(np.random.default_rng(n).normal(
        size=n).astype(np.float32))).values
    v = torch.cat([a - 1e-3, a, a + 1e-3, torch.tensor([float("nan"),
                                                        float("inf")])])
    got = count_pow2(a.expand(len(v), n).contiguous(), v[:, None])[:, 0]
    want = (a[None, :] <= v[:, None]).sum(-1)
    assert torch.equal(got, want)
    assert int(got.max()) == n and int(got.min()) == 0


def test_k3_sorting_a_row_changes_no_value():
    xs, rows, dmin, dmax = _k3_case(40, 111, 5, False, True)
    t = [torch.from_numpy(a) for a in (xs, rows, dmin, dmax)]
    ks, _ = k3_emulated(*t, 0.5)
    srt = warp_sort(t[1])
    assert bool(warp_sorted(srt).all())
    ks_s, _ = ref.dict_match_ref(t[0], srt, t[2], t[3], 0.5)
    assert torch.equal(ks.view(torch.int32), ks_s.view(torch.int32))


# ---------------------------------------------------------------- K2
TILE_BYTES = 48 * 1024
ROWS = 32


def k2_plan(R, P, size):
    """``plan<T>``: (rows a tile, chunk width, shared row stride)."""
    width, S = P, P | 1
    fit = TILE_BYTES // (S * size)
    if fit == 0:
        width = TILE_BYTES // (ROWS * size) - 1
        S, fit = width | 1, ROWS
    return min(fit, ROWS, R), width, S


def span_parts(addr, count, size):
    """``load_span``/``store_span``'s index ranges for ``count`` elements
    at byte address ``addr``: element-wise head, 16-byte chunks (as
    element ranges), element-wise tail."""
    vec = 16 // size
    head = min(((16 - addr % 16) % 16) // size, count)
    body = (count - head) // vec * vec
    chunks = [range(head + k * vec, head + (k + 1) * vec)
              for k in range(body // vec)]
    for c in chunks:  # each chunk is 16-byte aligned in global memory
        assert (addr + c.start * size) % 16 == 0
    return list(range(head)), chunks, list(range(head + body, count))


def k2_emulated(x, base_addr, out_addr):
    """K2's tiles over x (R, P) whose first element lies at byte address
    ``base_addr`` (the output at ``out_addr``): returns the sums and the
    count of times each element was loaded, walked and stored."""
    R, P = x.shape
    size = x.dtype.itemsize
    rows_per_tile, width, S = k2_plan(R, P, size)
    flat = x.reshape(-1)
    out = np.empty_like(flat)
    loads = np.zeros(flat.size, np.int64)
    walks = np.zeros(flat.size, np.int64)
    stores = np.zeros(flat.size, np.int64)
    for b in range(-(-R // rows_per_tile)):
        row0 = b * rows_per_tile
        rows = min(rows_per_tile, R - row0)
        g0 = row0 * P
        if width == P and S == P:
            addr = base_addr + g0 * size
            shift = addr % 16
            assert shift % size == 0  # the shifted tile is element-aligned
            count = rows * P
            smem = np.zeros(count, x.dtype)
            head, chunks, tail = span_parts(addr, count, size)
            for e in [*head, *[i for c in chunks for i in c], *tail]:
                smem[e] = flat[g0 + e]
                loads[g0 + e] += 1
            tile = smem.reshape(rows, P)
            acc = tile[:, 0].copy()
            walks[g0:g0 + count:P] += 1
            for j in range(1, P):  # the walk, one column at a time
                acc = acc + tile[:, j]
                tile[:, j] = acc
                walks[g0 + j:g0 + count:P] += 1
            head, chunks, tail = span_parts(out_addr + g0 * size, count,
                                            size)
            for e in [*head, *[i for c in chunks for i in c], *tail]:
                out[g0 + e] = smem[e]
                stores[g0 + e] += 1
            continue
        smem = np.zeros(rows * S, x.dtype)
        acc = None
        for col0 in range(0, P, width):
            w = min(width, P - col0)
            for e in range(rows * w):
                r, k = divmod(e, w)
                smem[r * S + k] = flat[g0 + r * P + col0 + k]
                loads[g0 + r * P + col0 + k] += 1
            tile = smem.reshape(rows, S)
            j = 0
            if col0 == 0:
                acc = tile[:, 0].copy()
                walks[g0:g0 + rows * P:P] += 1
                j = 1
            for k in range(j, w):
                acc = acc + tile[:, k]
                tile[:, k] = acc
                walks[g0 + col0 + k:g0 + rows * P:P] += 1
            for e in range(rows * w):
                r, k = divmod(e, w)
                out[g0 + r * P + col0 + k] = smem[r * S + k]
                stores[g0 + r * P + col0 + k] += 1
    return out.reshape(R, P), loads, walks, stores


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.float16])
@pytest.mark.parametrize("R,P", [(1, 1), (63, 2), (65, 111), (33, 255),
                                 (7, 1024), (3, 7000), (2, 30000)])
@pytest.mark.parametrize("offset", [0, 3])
def test_k2_tile_plan_sums_each_row_once_left_to_right(dtype, R, P, offset):
    """Rows ragged against the tile, a storage offset of ``offset``
    elements (not 16-byte aligned), every dtype; P = 7000 in f64 and
    P = 30000 in every dtype are cut into column chunks, and even P is
    padded."""
    rng = np.random.default_rng(R * P + offset)
    x = (rng.normal(0, 3, (R, P))
         * 10.0 ** rng.integers(-3, 3, (R, 1))).astype(dtype)
    x[:, 0] = -0.0
    size = x.dtype.itemsize
    got, loads, walks, stores = k2_emulated(x, 256 + offset * size, 512)
    assert (loads == 1).all() and (walks == 1).all() and (stores == 1).all()
    want = np.cumsum(x, axis=1)
    assert got.tobytes() == want.tobytes()
    # the port's CPU path on the same view (storage offset kept)
    store = torch.from_numpy(np.concatenate([np.zeros(offset, dtype),
                                             x.reshape(-1)]))
    view = store[offset:].view(R, P)
    assert view.storage_offset() == offset
    assert k2.seq_cumsum(view).numpy().tobytes() == want.tobytes()


def test_k2_plan_at_the_decode_shape():
    """R = 16384, P = 111 in f64: tiles of 32 whole rows (28,416 bytes,
    odd stride, no padding) in 512 CTAs; even P is padded; rows over 48 KB
    go in chunks."""
    assert k2_plan(16384, 111, 8) == (32, 111, 111)
    assert k2_plan(16384, 1024, 8) == (5, 1024, 1025)
    assert k2_plan(4, 7000, 8) == (4, 191, 191)
    assert -(-16384 // 32) == 512
