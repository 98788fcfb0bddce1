"""The port's CUDA kernels on the card: each held against its plain version
(decisions and carry equal, cumsum and KS distances bitwise, K4 within
1e-5; K3 also on NaNs of both signs, +-inf, +-0.0, ties and unsorted
candidates up to n = 4096, K2 on ragged and misaligned views), plus the
golden corpus through ``backend="cuda"``, the ``"ops"`` matcher, K1's
``chan`` operand and an adaptive session, and the LM serve path's decode
through K4.  Marked ``cuda``; without a card every
test skips.

Run on a machine with a card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda_kernels.py``.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import GOLDEN_CASES, golden_codec_kwargs, golden_signal  # noqa: E402
from repro_torch import IdealemCodec, KernelShapeError  # noqa: E402
from repro_torch.core.encoder import init_state  # noqa: E402
from repro_torch.kernels import dict_match as k3  # noqa: E402
from repro_torch.kernels import encode_step as k1  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import flash_decode as k4  # noqa: E402
from repro_torch.kernels import seq_cumsum as k2  # noqa: E402
from repro_torch.models.attention import ring_valid  # noqa: E402
from repro_torch.testing import k3_special  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _xs(C, nb, n, seed, dev):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(m, s, size=(C, nb // 2, n))
                        for m, s in [(0, 1), (5, 0.5)]], axis=1)
    return torch.sort(torch.from_numpy(x).to(dev, torch.float32),
                      dim=-1).values


@pytest.mark.parametrize("D,n", [(1, 7), (9, 32), (255, 111), (255, 256)])
def test_encode_scan_matches_plain(dev, D, n):
    xs = _xs(3, 300, n, D + n, dev)
    valid = torch.ones(xs.shape[:2], dtype=torch.bool, device=dev)
    valid[1, ::3] = False
    st = init_state(D, n, channels=3, device=dev)
    kw = dict(d_crit=(int(0.4 * n) + 0.5) / n, rel_tol=0.5)
    before = k1.launches
    got, gst = k1.encode_scan(xs, valid, st, **kw)
    assert k1.launches == before + 1
    want, wst = k1.encode_scan_torch(xs, valid, st, **kw)
    for a, b in zip((*got, *gst), (*want, *wst)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("D,n", [(1, 7), (9, 32), (255, 111), (255, 256)])
@pytest.mark.parametrize("cumulative", [False, True])
def test_encode_scan_error_bound_matches_plain(dev, D, n, cumulative):
    rng = np.random.default_rng(D + n)
    raw = torch.from_numpy(np.concatenate(
        [rng.normal(m, s, size=(3, 150, n)) for m, s in [(0, 1), (5, 0.5)]],
        axis=1)).to(dev, torch.float32)
    xs = torch.sort(raw, dim=-1).values
    valid = torch.ones(xs.shape[:2], dtype=torch.bool, device=dev)
    valid[2, ::4] = False
    st = init_state(D, n, channels=3, device=dev, raw=True)
    kw = dict(d_crit=(int(0.4 * n) + 0.5) / n, rel_tol=0.5, raw=raw,
              error_bound=2.0 if cumulative else 1.5,
              error_cumulative=cumulative)
    got, gst = k1.encode_scan(xs, valid, st, **kw)
    want, wst = k1.encode_scan_torch(xs, valid, st, **kw)
    for a, b in zip((*got, *gst), (*want, *wst)):
        assert torch.equal(a, b)
    assert k1.dict_in_smem(n, D, True) == (D * n <= 255 * 111)


@pytest.mark.parametrize("D,n,minmax,bound,nonfinite", [
    (9, 16, True, None, False), (9, 16, False, None, True),
    (255, 32, False, None, True), (255, 111, True, None, False),
    (255, 256, True, None, False), (9, 32, True, 0.5, False),
    (255, 32, False, 0.5, True), (255, 111, True, 0.5, False)])
def test_encode_scan_chan_matches_plain(dev, D, n, minmax, bound,
                                        nonfinite):
    """K1's chan operand: lanes of widths n-3..n (+inf pads), per-lane
    d_crit, error metric and armed gate, NaN/+-inf/-0.0 blocks."""
    from repro_torch.core.encoder import chan_params
    from repro_torch.testing import mixed_cohort
    blocks, valid, nf, dc, ec, ebo = mixed_cohort(6, 200, n, seed=D + n,
                                                  nonfinite=nonfinite)
    raw = torch.from_numpy(blocks).to(dev)
    xs = torch.sort(raw, dim=-1).values
    vt = torch.from_numpy(valid).to(dev)
    kw = dict(d_crit=0.0, rel_tol=0.5, use_minmax=minmax,
              chan=chan_params(nf, dc, ec, ebo, dev).block())
    if bound is not None:
        kw.update(raw=raw, error_bound=bound)
    st = init_state(D, n, channels=6, device=dev, raw=bound is not None)
    before = k1.launches
    got, gst = k1.encode_scan(xs, vt, st, **kw)
    assert k1.launches == before + 1
    want, wst = k1.encode_scan_torch(xs, vt, st, **kw)
    for a, b in zip((*got, *gst), (*want, *wst)):
        assert _bits_equal(a, b)


def test_encode_scan_chan_grown_rows(dev):
    """Rows stored at width n - 1 with NaNs, grown to n ([.., NaN, +inf]),
    queried by candidates whose +inf pads fall inside their width."""
    from repro_torch.core.encoder import chan_params, repad_state_n
    from repro_torch.testing import mixed_cohort
    n = 32
    wa = [n - 1, n - 3, n - 2, n - 1, n - 4, n - 2]
    st = init_state(255, n - 1, channels=6, device=dev)
    for feed, widths in ((0, wa), (1, [n] + wa[1:])):
        blocks, valid, _, dc, ec, ebo = mixed_cohort(
            6, 300, n - 1 + feed, seed=7 + feed, widths=widths,
            nonfinite=True)
        xs = torch.sort(torch.from_numpy(blocks).to(dev), -1).values
        vt = torch.from_numpy(valid).to(dev)
        kw = dict(d_crit=0.0, rel_tol=0.5, use_minmax=False,
                  chan=chan_params(widths, dc, ec, ebo, dev).block())
        if feed:
            st = repad_state_n(st, n)
        got, gst = k1.encode_scan(xs, vt, st, **kw)
        want, wst = k1.encode_scan_torch(xs, vt, st, **kw)
        for a, b in zip((*got, *gst), (*want, *wst)):
            assert _bits_equal(a, b)
        st = gst


def test_adaptive_session_one_launch_per_feed(dev, monkeypatch):
    """An adaptive session on the card: one K1 launch a feed (none of K3),
    streams equal to the per-channel loop's and to backend="torch"."""
    from repro_torch.core.session import _ADAPTIVE_LOOP_ENV
    rng = np.random.default_rng(0)
    t = np.arange(16 * 60, dtype=np.float64)
    data = np.stack([rng.normal(0, 1, t.size), 0.03 * t +
                     rng.normal(0, 0.02, t.size)] * 2)
    kw = dict(mode="std", block_size=16, num_dict=8, adaptive=True)

    def run(**extra):
        s = IdealemCodec(**kw, **extra).session(channels=4)
        out = [s.feed(data[:, lo:lo + 160]) for lo in range(0, t.size, 160)]
        return out + [s.finish()], s

    n1, n3 = k1.launches, k3.launches
    fused, s = run()
    assert k1.launches - n1 == 6 and k3.launches == n3
    assert s._mixed.dispatches == 6
    assert any(st.mode_switches for st in s.stats)
    assert run(backend="torch")[0] == fused
    monkeypatch.setenv(_ADAPTIVE_LOOP_ENV, "1")
    loop, ls = run()
    assert ls._mixed is None and loop == fused


def _bits_equal(a, b):
    if a.dtype == torch.float32:  # NaN rows of a carry compare by their bits
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("traffic", ["turnover", "special"])
@pytest.mark.parametrize("D,n,minmax", [(9, 7, False), (255, 32, True),
                                        (255, 111, True), (255, 111, False)])
def test_encode_scan_turnover_and_nonfinite_blocks(dev, traffic, D, n,
                                                   minmax):
    """A dictionary that turns over (more levels than rows) and blocks with
    ties, -0.0/+0.0, +-inf and NaN tails: decisions and carry equal to the
    plain scan bit for bit (without the eq. 3 gate the KS sees the NaNs)."""
    rng = np.random.default_rng(D * n)
    if traffic == "turnover":
        level = rng.integers(0, 384, (2, 1200, 1)).astype(np.float64)
        x = rng.normal(level, 1.0, (2, 1200, n))
    else:
        x = np.round(rng.normal(0, 1, (2, 400, n)), 1)
        x[rng.random(x.shape) < 0.05] = -0.0
        kind = rng.integers(0, 4, x.shape[:2])
        x[kind == 1, :max(1, n // 5)] = np.nan
        x[kind == 2, 0] = np.inf
        x[kind == 3, -1] = -np.inf
    xs = torch.sort(torch.from_numpy(x).to(dev, torch.float32), -1).values
    valid = torch.ones(xs.shape[:2], dtype=torch.bool, device=dev)
    valid[1, ::7] = False
    st = init_state(D, n, channels=2, device=dev)
    kw = dict(d_crit=(int(0.4 * n) + 0.5) / n, rel_tol=0.5,
              use_minmax=minmax)
    got, gst = k1.encode_scan(xs, valid, st, **kw)
    want, wst = k1.encode_scan_torch(xs, valid, st, **kw)
    for a, b in zip((*got, *gst), (*want, *wst)):
        assert _bits_equal(a, b)
    if traffic == "turnover" and D == 255:
        assert bool(got[2].any())  # the FIFO overwrote


@pytest.mark.parametrize("D,n", [(1, 7), (8, 32), (9, 111), (255, 256)])
@pytest.mark.parametrize("C", [1, 64])
def test_dict_match_matches_plain(dev, C, D, n):
    rng = np.random.default_rng(C + D + n)
    xs = torch.sort(torch.from_numpy(rng.normal(size=(C, n))).to(
        dev, torch.float32), dim=-1).values
    rows = torch.from_numpy(rng.normal(size=(C, D, n))).to(dev, torch.float32)
    rows[:, 0] = xs[:, torch.randperm(n, device=dev)]  # distance 0
    dmin, dmax = rows.amin(-1), rows.amax(-1)
    before = k3.launches
    ks, mm = k3.dict_match_cuda(xs, rows, dmin, dmax, 0.3)
    assert k3.launches == before + 1
    ks_p, mm_p = ref.dict_match_ref(xs, rows, dmin, dmax, 0.3)
    assert torch.equal(ks, ks_p) and torch.equal(mm, mm_p)
    assert not bool(ks[:, 0].any())
    srt = torch.sort(rows, dim=-1).values
    assert torch.equal(ops.dict_match_ks(xs, srt),
                       ref.ks_counts(xs, srt, float(np.float32(1.0 / n))))


@pytest.mark.parametrize("C,D,n", [(64, 255, 32), (64, 255, 111),
                                   (2, 40, 33), (1, 1, 1), (2, 9, 4096)])
@pytest.mark.parametrize("cand_sorted", [True, False])
@pytest.mark.parametrize("rows_sorted", [True, False])
def test_dict_match_special_values(dev, C, D, n, cand_sorted, rows_sorted):
    xs, rows, lo, hi = k3_special(C, D, n, C + D + n, cand_sorted,
                                  rows_sorted)
    t = [torch.from_numpy(a).to(dev) for a in (xs, rows, lo, hi)]
    ks, mm = k3.dict_match_cuda(*t, 0.3)
    ks_p, mm_p = ref.dict_match_ref(*t, 0.3)
    assert torch.equal(ks.view(torch.int32), ks_p.view(torch.int32))
    assert torch.equal(mm, mm_p)


def test_dict_match_plan_fills_the_card(dev):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n in (32, 111):  # every warp of the grid in one wave
        plan = k3.plan(64, 255, n)
        assert sms <= plan["ctas"] <= plan["cta_slots"]
        assert plan["warps"] == 8
    assert k3.plan(1, 1, k3.MAX_N)["warps"] >= 1


def test_dict_match_rejects_bad_operands(dev):
    xs = torch.zeros((2, 8), device=dev)
    rows = torch.zeros((2, 3, 8), device=dev)
    lo = torch.zeros((2, 3), device=dev)
    with pytest.raises(KernelShapeError):
        k3.dict_match_cuda(xs.double(), rows, lo, lo, 0.5)
    with pytest.raises(KernelShapeError):
        k3.dict_match_cuda(xs, rows[:, :, :4], lo, lo, 0.5)
    with pytest.raises(KernelShapeError):
        k3.dict_match_cuda(xs, rows.transpose(1, 2).contiguous()
                           .transpose(1, 2), lo, lo, 0.5)


@pytest.mark.parametrize("mode", ["std", "delta"])
def test_ops_matcher_streams_equal_fused(dev, mode):
    x = np.random.default_rng(3).normal(size=(4, 16 * 200))
    outs = {}
    for matcher in ("ops", "fused"):
        k3.launches = 0
        codec = IdealemCodec(mode=mode, block_size=16, num_dict=32,
                             alpha=0.05, matcher=matcher, error_bound=2.0)
        s = codec.session(channels=4)
        outs[matcher] = [a + b for a, b in zip(s.feed(x), s.finish())]
        if matcher == "ops":
            assert k3.launches == 200
    assert outs["ops"] == outs["fused"]


def test_encode_scan_rejects_bad_operands(dev):
    xs = _xs(1, 4, 8, 0, dev)
    valid = torch.ones((1, 4), dtype=torch.bool, device=dev)
    with pytest.raises(KernelShapeError):
        k1.encode_scan(xs.double(), valid, init_state(4, 8, channels=1,
                                                       device=dev),
                       d_crit=0.5, rel_tol=0.5)
    with pytest.raises(KernelShapeError):
        k1.encode_scan(xs, valid, init_state(300, 8, channels=1, device=dev),
                       d_crit=0.5, rel_tol=0.5)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.float16])
def test_seq_cumsum_bitwise(dev, dtype):
    x = np.random.default_rng(1).normal(0, 3, (4099, 111)).astype(dtype)
    x[:, 0] = -0.0
    got = k2.seq_cumsum(torch.from_numpy(x).to(dev)).cpu().numpy()
    assert got.tobytes() == np.cumsum(x, axis=1).tobytes()


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.float16])
@pytest.mark.parametrize("R,P", [(R, P) for R in (1, 63, 65, 16383)
                                 for P in (1, 2, 111, 255, 1024)]
                         + [(33, 30000)])
def test_seq_cumsum_ragged_and_misaligned(dev, dtype, R, P):
    """Ragged tiles, even widths (padded rows), rows over 48 KB in every
    dtype (column chunks, each row's sum carried from chunk to chunk) and a
    view whose storage offset (3 elements) is not 16-byte aligned."""
    x = np.random.default_rng(R + P).normal(0, 3, (R, P)).astype(dtype)
    x[:, 0] = -0.0
    want = np.cumsum(x, axis=1).tobytes()
    base = torch.from_numpy(np.concatenate([np.zeros(3, dtype),
                                            x.reshape(-1)])).to(dev)
    for view in (base[3:].view(R, P), base[3:].clone().view(R, P)):
        got = k2.seq_cumsum(view)
        assert got.cpu().numpy().tobytes() == want
        assert torch.equal(got, k2.seq_cumsum_torch(view))


def test_empty_operands_launch_nothing(dev):
    k1.launches = k2.launches = 0
    for shape in [(0, 5), (4, 0)]:
        out = k2.seq_cumsum(torch.zeros(shape, dtype=torch.float64,
                                        device=dev))
        assert out.shape == shape
    xs = _xs(1, 4, 8, 0, dev)[:, :0]
    (h, _, _), _ = k1.encode_scan(
        xs, torch.ones((1, 0), dtype=torch.bool, device=dev),
        init_state(4, 8, channels=1, device=dev), d_crit=0.5, rel_tol=0.5)
    assert h.shape == (1, 0)
    assert k1.launches == k2.launches == 0


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_golden_on_card(dev, name):
    kw = golden_codec_kwargs(name)
    kw["backend"] = "cuda"
    codec = IdealemCodec(**kw)
    blob = codec.encode(golden_signal(name))
    path = os.path.join(os.path.dirname(__file__), "golden", f"{name}.idlm")
    with open(path, "rb") as f:
        assert blob == f.read()
    assert codec.decode(blob).tobytes() == codec.decode(
        blob, backend="numpy").tobytes()


def _k4_case(B, H, Hkv, hd, C, dtype, dev, seed=0):
    """K4 operands: a query scaled by hd**-0.5, as ``decode_attention``
    passes it; rows masked as a ring cache at several positions and
    windows (``ring_valid``), the last row with no valid position."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(B, H, hd)) * hd ** -0.5).to(
        dev, torch.float32)
    k = torch.from_numpy(rng.normal(size=(B, C, Hkv, hd))).to(dev, dtype)
    v = torch.from_numpy(rng.normal(size=(B, C, Hkv, hd))).to(dev, dtype)
    rows = [ring_valid(int(pos), C, window, dev)
            for pos, window in zip(rng.integers(0, 3 * C, B),
                                   [None, 3, C // 2 + 1] * B)]
    valid = torch.stack(rows[:B])
    valid[-1] = False
    return q, k, v, valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("B,H,Hkv,hd,C", [
    (2, 8, 2, 16, 1024), (1, 4, 4, 32, 512), (3, 16, 8, 64, 2048),
    (2, 6, 6, 64, 512),                       # the JAX test's shapes
    (3, 8, 8, 128, 700), (3, 32, 8, 128, 2048), (3, 32, 2, 64, 33),
    (2, 4, 4, 64, 1),                         # G in {1, 4, 16}, any C
])
def test_flash_decode_matches_plain(dev, B, H, Hkv, hd, C, dtype):
    q, k, v, valid = _k4_case(B, H, Hkv, hd, C, dtype, dev, seed=C + hd)
    before = k4.launches
    got = k4.flash_decode(q, k, v, valid)
    torch.cuda.synchronize()
    assert k4.launches == before + 1
    want = k4.flash_decode_torch(q, k, v, valid)
    assert float((got - want).abs().max()) <= 1e-5
    mean_v = v[-1].float().mean(0).repeat_interleave(H // Hkv, dim=0)
    assert float((got[-1] - mean_v).abs().max()) <= 1e-5
    # a mask broadcast over the batch is read in place
    one = valid[:1].expand(B, C)
    assert float((k4.flash_decode(q, k, v, one)
                  - k4.flash_decode_torch(q, k, v, one)).abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,hd,C", [
    (2, 8, 2, 64, 64 * 37 + 9),    # a ragged last split and last tile
    (3, 24, 4, 128, 1000),          # G = 6: head groups of 2
    (1, 32, 8, 128, 32768),         # decode_32k at B = 1
])
def test_flash_decode_split_shapes(dev, B, H, Hkv, hd, C, dtype):
    q, k, v, valid = _k4_case(B, H, Hkv, hd, C, dtype, dev, seed=C)
    splits = k4._splits(q.device, dtype, B, C, Hkv, H // Hkv, hd)
    tiles = -(-C // 64)
    assert 1 < splits <= tiles
    full = torch.ones_like(valid)
    for mask in (valid, full):  # the last row all masked, then all valid
        got = k4.flash_decode(q, k, v, mask)
        want = k4.flash_decode_torch(q, k, v, mask)
        assert float((got - want).abs().max()) <= 1e-5
    mean_v = v[-1].float().mean(0).repeat_interleave(H // Hkv, dim=0)
    got = k4.flash_decode(q, k, v, valid)
    assert float((got[-1] - mean_v).abs().max()) <= 1e-5


def test_flash_decode_rejects_bad_operands(dev):
    q, k, v, valid = _k4_case(2, 8, 2, 16, 64, torch.bfloat16, dev)
    before = k4.launches
    bad = [(q.double(), k, v, valid), (q, k, v.float(), valid),
           (q[..., :12].contiguous(), k[..., :12].contiguous(),
            v[..., :12].contiguous(), valid),         # hd not a multiple of 8
           (q, k.transpose(1, 2).contiguous().transpose(1, 2), v, valid),
           (q, k, v, valid.int()), (q[:, :7], k, v, valid),
           (q, k, v, valid.cpu())]
    for args in bad:
        with pytest.raises(KernelShapeError):
            k4.flash_decode(*args)
    big = torch.zeros((1, 64, 1, 2048), dtype=torch.float32, device=dev)
    with pytest.raises(KernelShapeError, match="shared memory"):
        k4.flash_decode(torch.zeros((1, 64, 2048), device=dev), big, big,
                        torch.ones((1, 64), dtype=torch.bool, device=dev))
    assert k4.launches == before


def test_serve_decode_through_k4(dev):
    """The SMOKE granite decode on the card: one K4 launch per layer and
    step, logits close to the plain attention core's (bf16 rounding of the
    attention output before ``wo``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine
    cfg = get_config("granite_3_8b", smoke=True)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 10))).to(dev)
    logits = {}
    for backend in ("cuda", "torch"):
        cache = lm.init_cache(cfg, 4, 16, device=dev)
        k4.launches = 0
        out = []
        for t in range(toks.shape[1]):
            lg, cache = lm.decode_step(params, cache, toks[:, t:t + 1], cfg,
                                       backend=backend)
            out.append(lg)
        logits[backend] = torch.cat(out, dim=1)
        assert k4.launches == (cfg.num_layers * toks.shape[1]
                               if backend == "cuda" else 0)
    assert float((logits["cuda"] - logits["torch"]).abs().max()) < 0.05
    eng = ServeEngine(cfg, params, max_seq=32)
    out = eng.generate(toks[:, :4].cpu().numpy(), 6)
    assert out.shape == (4, 6)
    np.testing.assert_array_equal(eng.generate(toks[:, :4].cpu().numpy(), 6),
                                  out)


def test_unembed_is_full_float32_under_tf32(dev):
    """The float32 unembedding ignores a caller's TF32 setting on the card
    (TF32 would miss a float64 product by ~1e-3 here, float32 by ~1e-7)."""
    from types import SimpleNamespace
    from repro_torch.models.layers import unembed
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(8, 1, 4096))).to(dev, torch.float32)
    w = torch.from_numpy(rng.normal(size=(512, 4096)) / 64).to(
        dev, torch.float32)
    want = (x.double() @ w.double().T).float()
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = unembed({"table": w}, x, SimpleNamespace(tie_embeddings=True))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert float((got - want).abs().max()) < 1e-5
