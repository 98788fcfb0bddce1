"""Adaptive mode selection and the batched mixed-mode scan: the PyTorch
port vs the JAX reference, on the CPU.

The port's selector is a copy of the reference's and is held to the same
unit tests.  The mixed scan is held arm for arm: the port's ``reference``
matcher (the ``torch`` backend) against the reference's ``jax`` arm, its
``fused`` matcher (K1 with its ``chan`` operand; on the CPU its plain
version) against the Pallas kernel in interpret mode, and its numpy oracle
against the reference's.  Inputs are made from a seed with numpy and handed
to both.  Tolerance: decisions, FIFO counts, extremes, raw rows and stream
bytes equal; sorted rows equal by value (``assert_array_equal``: -0.0 ==
0.0 and NaN == NaN; a tie between the two zeros may sort either way); raw
KS values within 2**-22 (quotients against products by ``f32(1/n)``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import IdealemCodec as JaxCodec  # noqa: E402
from repro.core import encoder as jenc  # noqa: E402
from repro.core import ks as jks  # noqa: E402
from repro.core.npref import encode_decisions_mixed_np as jax_mixed_np  # noqa: E402
from repro.core.select import SelectorConfig as JaxSelectorConfig  # noqa: E402
from repro.core.session import MixedCohort as JaxCohort  # noqa: E402
from repro.core.stream import decode_stream as jax_decode_stream  # noqa: E402
from repro.kernels.encode_step import encode_step_pallas  # noqa: E402
from repro_torch import IdealemCodec  # noqa: E402
from repro_torch.core import encoder as tenc  # noqa: E402
from repro_torch.core import ks as tks  # noqa: E402
from repro_torch.core.npref import encode_decisions_mixed_np  # noqa: E402
from repro_torch.core.select import ChannelSelector, SelectorConfig  # noqa: E402
from repro_torch.core.session import _ADAPTIVE_LOOP_ENV, MixedCohort  # noqa: E402
from repro_torch.core.stream import decode_stream  # noqa: E402
from repro_torch.kernels import encode_step as k1  # noqa: E402
from repro_torch.kernels.ref import ks_counts  # noqa: E402
from repro_torch.testing import mixed_cohort  # noqa: E402

B = 16
KS_TOL = 2.0 ** -22


def _noise(n, seed=0):
    return np.random.default_rng(seed).normal(0.0, 1.0, n)


def _smooth(n, seed=0):
    t = np.arange(n)
    return np.sin(t * 0.01) * 5 + _noise(n, seed) * 0.01


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _same_out(jax_out, torch_out):
    for x, y in zip(jax_out, torch_out):
        _eq(x, y.numpy())


def _same_carry(jst, tst):
    """Sorted rows by value, every other field exactly."""
    _eq(jst.sorted_blocks, tst.sorted_blocks.numpy())
    for f in ("dmin", "dmax", "valid", "count", "raw_blocks"):
        a, b = np.asarray(getattr(jst, f)), getattr(tst, f).numpy()
        if a.dtype.kind == "f":
            a, b = a.view(np.uint32), b.view(np.uint32)
            b = np.where(np.isnan(getattr(tst, f).numpy()), a, b)
        _eq(a, b)


# ----------------------------------------------------------------- selector
def test_warmup_gates_predictors():
    sel = ChannelSelector(block_size=16, config=SelectorConfig(
        warmup_blocks=4))
    sel.observe(_noise(16 * 3))
    assert sel.predictors() is None
    assert sel.decide(3) is None
    sel.observe(_noise(16))
    assert sel.predictors() is not None
    assert sel.events == []


def test_predictors_separate_regimes():
    sel = ChannelSelector(block_size=32)
    sel.observe(_noise(32 * 8))
    sel2 = ChannelSelector(block_size=32)
    sel2.observe(_smooth(32 * 8))
    assert sel.predictors()[0] < 0.35 < 0.7 < sel2.predictors()[0]


def test_smooth_signal_switches_to_delta_and_sticks():
    cfg = SelectorConfig(warmup_blocks=4, patience=2, min_dwell_blocks=8)
    sel = ChannelSelector(block_size=32, mode="std", config=cfg)
    events = []
    for i in range(20):
        sel.observe(_smooth(32, seed=i))
        ev = sel.decide(i + 1)
        if ev is not None:
            events.append(ev)
    assert len(events) == 1
    assert events[0].old_mode == "std" and events[0].new_mode == "delta"
    assert sel.mode == "delta"


def test_patience_requires_consecutive_targets():
    cfg = SelectorConfig(warmup_blocks=4, patience=3, min_dwell_blocks=0)
    sel = ChannelSelector(block_size=32, mode="std", config=cfg)
    sel.observe(_smooth(32 * 4))
    assert sel.decide(4) is None
    assert sel.decide(5) is None
    assert sel.decide(6) is not None
    assert sel.mode == "delta"


def test_min_dwell_blocks_spaces_switches():
    cfg = SelectorConfig(warmup_blocks=4, patience=1, min_dwell_blocks=100)
    sel = ChannelSelector(block_size=32, mode="std", config=cfg)
    sel.observe(_smooth(32 * 4))
    assert sel.decide(10) is not None
    sel.observe(_noise(32 * 4))
    assert sel.decide(50) is None
    assert sel.decide(109) is None
    assert sel.decide(110) is not None


def test_mode_boundaries_are_sticky():
    cfg = SelectorConfig(hysteresis=0.1, residual_rho=0.35, delta_rho=0.7)
    lo = ChannelSelector(block_size=16, mode="std", config=cfg)
    hi = ChannelSelector(block_size=16, mode="residual", config=cfg)
    for rho in (0.30, 0.36, 0.44):
        assert lo._target_mode(rho) == "std"
        assert hi._target_mode(rho) == "residual"
    assert lo._target_mode(0.46) == "residual"
    assert hi._target_mode(0.24) == "std"


def test_scale_tightens_and_relaxes_with_hysteresis():
    cfg = SelectorConfig(drift_hi=0.5, drift_lo=0.2, d_crit_scales=(0.75, 1.0))
    sel = ChannelSelector(block_size=16, config=cfg)
    assert sel._target_scale(1.0, 0.1) == 1.0
    assert sel._target_scale(1.0, 0.6) == 0.75
    sel.scale = 0.75
    assert sel._target_scale(1.0, 0.3) == 0.75
    assert sel._target_scale(1.0, 0.1) == 1.0


def test_selector_validation():
    with pytest.raises(ValueError, match="warmup_blocks"):
        ChannelSelector(16, config=SelectorConfig(warmup_blocks=1))
    with pytest.raises(ValueError, match="mode"):
        ChannelSelector(16, mode="huffman")


@pytest.mark.parametrize("seed", [0, 1])
def test_selector_events_equal_reference(seed):
    from repro.core.select import ChannelSelector as JaxSelector
    rng = np.random.default_rng(seed)
    x = np.concatenate([_noise(32 * 40, seed), _smooth(32 * 40, seed),
                        rng.normal(3, 4, 32 * 40)])
    cfg = dict(warmup_blocks=4, patience=2, min_dwell_blocks=8)
    ours = ChannelSelector(32, config=SelectorConfig(**cfg))
    ref = JaxSelector(32, config=JaxSelectorConfig(**cfg))
    for i in range(0, len(x), 96):
        for sel in (ours, ref):
            sel.observe(x[i:i + 96])
            sel.decide(i // 32)
    assert [e.as_dict() for e in ours.events] == \
        [e.as_dict() for e in ref.events]
    assert len(ours.events) >= 2


# ------------------------------------------------- the mixed-mode scan
def _paper_case():
    """The reference test's cohort: widths 16/15/12, ragged block counts,
    near-duplicate blocks, per-lane d_crit, error metric and armed gate."""
    rng = np.random.default_rng(6)
    C, nb = 3, 20
    n_valid = np.array([16, 15, 12])
    blocks = np.full((C, nb, B), np.inf, dtype=np.float32)
    valid = np.zeros((C, nb), dtype=bool)
    for ci in range(C):
        nbi = nb - 2 * ci
        base = rng.normal(0, 1, (nbi // 2 + 1, n_valid[ci]))
        rows = np.repeat(base, 2, axis=0)[:nbi]
        blocks[ci, :nbi, :n_valid[ci]] = rows + rng.normal(0, 0.03,
                                                           rows.shape)
        valid[ci, :nbi] = True
    kw = dict(n_valid=n_valid, d_crit=np.array([0.5, 0.4, 0.6], np.float32),
              error_bound=0.5, error_cumulative=np.array([False, True, False]),
              eb_on=np.array([True, False, True]))
    return blocks, valid, 4, kw


def _generated_case(nonfinite, minmax, bound):
    blocks, valid, nf, dc, ec, ebo = mixed_cohort(4, 24, B, seed=11,
                                                  nonfinite=nonfinite)
    kw = dict(n_valid=nf, d_crit=dc, error_cumulative=ec, eb_on=ebo,
              use_minmax=minmax, error_bound=bound)
    return blocks, valid, 6, kw


CASES = {
    "paper": _paper_case,
    "bound": lambda: _generated_case(False, True, 0.5),
    "nonfinite": lambda: _generated_case(True, True, None),
    "nonfinite_no_gate": lambda: _generated_case(True, False, None),
    "nonfinite_no_gate_bound": lambda: _generated_case(True, False, 0.5),
}


def _run_both(blocks, valid, D, kw, matcher, cuts, jst=None, tst=None):
    """The reference's and the port's mixed scan over the block ranges
    ``cuts``, threading each one's carry; returns both decision triples
    (concatenated) and carries."""
    C, _, n = blocks.shape
    raw = kw.get("error_bound") is not None
    if jst is None:
        jst = jenc.init_state(D, n, channels=C, raw=raw)
        tst = tenc.init_state(D, n, channels=C, device="cpu", raw=raw)
    jout, tout = [], []
    for lo, hi in cuts:
        o, jst = jenc.encode_decisions_mixed(
            jnp.asarray(blocks[:, lo:hi]), num_dict=D,
            valid=jnp.asarray(valid[:, lo:hi]), matcher=matcher, state=jst,
            **kw)
        jout.append(o)
        o, tst = tenc.encode_decisions_mixed(
            torch.from_numpy(blocks[:, lo:hi]), num_dict=D,
            valid=torch.from_numpy(valid[:, lo:hi]), matcher=matcher,
            state=tst, **kw)
        tout.append(o)
    j = tuple(np.concatenate([np.asarray(o[k]) for o in jout], 1)
              for k in range(3))
    t = tuple(torch.cat([o[k] for o in tout], 1) for k in range(3))
    return j, t, jst, tst


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("matcher", [None, "fused"])
def test_mixed_scan_matches_reference(matcher, case, chunked):
    blocks, valid, D, kw = CASES[case]()
    nb = blocks.shape[1]
    cuts = [(0, 8), (8, nb)] if chunked else [(0, nb)]
    j, t, jst, tst = _run_both(blocks, valid, D, kw, matcher, cuts)
    _same_out(j, t)
    _same_carry(jst, tst)
    h = t[0][torch.from_numpy(valid)]
    assert bool(h.any()) and not bool(h.all())  # hits and misses


@pytest.mark.parametrize("matcher", [None, "fused"])
def test_grown_nan_rows_queried_by_inf(matcher):
    """Rows stored at width n - 1 with NaNs, grown by ``repad_state_n`` to
    [.., NaN, +inf], then queried by candidates whose +inf pads fall inside
    their width (the eq. 3 gate off, so the KS sees them): the reference
    arm's binary search and the fused arm's broadcast counts are followed
    each by its counterpart."""
    n, C = B, 6
    wa = [n - 1, n - 3, n - 2, n - 1, n - 4, n - 2]
    a, va, _, dc, ec, ebo = mixed_cohort(C, 30, n - 1, seed=3, widths=wa,
                                         nonfinite=True)
    kw = dict(n_valid=wa, d_crit=dc, error_cumulative=ec, eb_on=ebo,
              use_minmax=False)
    _, _, jst, tst = _run_both(a, va, 5, kw, matcher, [(0, 30)])
    jst, tst = jenc.repad_state_n(jst, n), tenc.repad_state_n(tst, n)
    rows = tst.sorted_blocks
    grown = (torch.isnan(rows[..., :-1]) & torch.isinf(rows[..., 1:])).any(-1)
    assert int((grown & tst.valid).sum()) > 0
    wb = [n] + wa[1:]
    b, vb, _, _, _, _ = mixed_cohort(C, 30, n, seed=4, widths=wb,
                                     nonfinite=True)
    kw["n_valid"] = wb
    j, t, jst, tst = _run_both(b, vb, 5, kw, matcher, [(0, 30)], jst, tst)
    _same_out(j, t)
    _same_carry(jst, tst)


def test_mixed_numpy_oracle_matches_reference():
    blocks, valid, D, kw = _paper_case()
    ours = encode_decisions_mixed_np(blocks, num_dict=D, valid=valid, **kw)
    ref = jax_mixed_np(blocks, num_dict=D, valid=valid, **kw)
    for a, b in zip(ours, ref):
        _eq(a, b)
    states = [None] * 3
    parts = []
    for lo, hi in ((0, 8), (8, 20)):
        out, states = encode_decisions_mixed_np(
            blocks[:, lo:hi], num_dict=D, valid=valid[:, lo:hi],
            states=states, **kw)
        parts.append(out)
    for k in range(3):
        _eq(np.concatenate([p[k] for p in parts], 1), ours[k])
    dev = tenc.encode_decisions_mixed(torch.from_numpy(blocks), num_dict=D,
                                      valid=torch.from_numpy(valid), **kw)
    for d, r in zip(dev, ours):
        _eq(np.where(valid, d.numpy(), 0), r)


@pytest.mark.parametrize("grow_to,shrink_to", [(16, 12), (13, 12)])
def test_repad_state_grow_shrink(grow_to, shrink_to):
    blocks, valid, nf, dc, ec, ebo = mixed_cohort(2, 10, 12, seed=5)
    kw = dict(n_valid=nf, d_crit=dc, error_cumulative=ec, eb_on=ebo,
              error_bound=0.5)
    _, _, jst, tst = _run_both(blocks, valid, 4, kw, None, [(0, 10)])
    wide, jwide = tenc.repad_state_n(tst, grow_to), \
        jenc.repad_state_n(jst, grow_to)
    assert wide.sorted_blocks.shape[-1] == grow_to
    assert bool(torch.all(wide.sorted_blocks[..., 12:] == np.inf))
    assert bool(torch.all(wide.raw_blocks[..., 12:] == np.inf))
    _same_carry(jwide, wide)
    back = tenc.repad_state_n(wide, shrink_to)
    _same_carry(jenc.repad_state_n(jwide, shrink_to), back)
    _eq(back.sorted_blocks.numpy(), tst.sorted_blocks.numpy())
    assert tenc.repad_state_n(tst, 12) is tst


def test_mixed_rejects_matchers_without_masked_variant():
    blocks, valid, D, kw = _paper_case()
    for m in ("ops", "auto"):
        with pytest.raises(ValueError, match="mixed-mode scan"):
            tenc.encode_decisions_mixed(torch.from_numpy(blocks), num_dict=D,
                                        matcher=m, **kw)


def test_chan_operand_layout_matches_reference():
    chan = tenc.chan_params([32, 31, 0], [0.3, 0.25, 0.5], [False, True,
                                                             False],
                            [True, True, False], "cpu")
    ref = jenc._chan_params_host([32, 31, 0], [0.3, 0.25, 0.5],
                                 [False, True, False], [True, True, False])
    for c in range(3):
        _eq(np.asarray(jenc._chan_block(ref._replace(
            **{f: getattr(ref, f)[c] for f in ref._fields}))),
            chan.block()[c].numpy())
    assert chan.n.tolist() == [32, 31, 1]  # an empty lane's guard


# ------------------------------------------------- KS on padded rows
def test_searchsorted_pins_the_reference_on_any_row():
    """The reference's binary search probe for probe, on sorted rows and on
    rows that are not sorted NaN-last (grown rows [.., NaN, +inf])."""
    rng = np.random.default_rng(0)
    rows = np.round(rng.normal(size=(40, 9)), 1).astype(np.float32)
    rows[rng.random(rows.shape) < 0.1] = np.nan
    rows[rng.random(rows.shape) < 0.1] = np.inf
    rows[rng.random(rows.shape) < 0.1] = -0.0
    rows = np.sort(rows, axis=1)
    rows[::2, -2:] = [np.nan, np.inf]          # grown rows
    qs = np.concatenate([rows[::-1], np.full((40, 3), [np.inf, np.nan,
                                                      -np.inf])], 1)
    qs = qs.astype(np.float32)
    got = tks.searchsorted_right(torch.from_numpy(rows),
                                 torch.from_numpy(qs)).numpy()
    for r, q, g in zip(rows, qs, got):
        _eq(jnp.searchsorted(jnp.asarray(r), jnp.asarray(q), side="right"),
            g)


def test_reference_matcher_counts_nans_as_the_reference():
    """The static ``torch`` backend on NaN blocks without the eq. 3 gate
    (so the KS sees them): decisions equal to the ``jax`` arm's.  With
    ``torch.searchsorted`` the port's counts differed there."""
    rng = np.random.default_rng(1)
    x = np.round(rng.normal(size=(60, 8)), 1).astype(np.float32)
    kind = rng.integers(0, 3, 60)
    x[kind == 1, :2] = np.nan
    x[kind == 2, 0] = np.inf
    kw = dict(num_dict=6, d_crit=0.45, rel_tol=0.5, use_minmax=False)
    j = jenc.encode_decisions(jnp.asarray(x), **kw)
    t = tenc.encode_decisions(torch.from_numpy(x), **kw)
    _same_out(j, t)


def test_masked_ks_differs_from_static_on_an_inf_block():
    """Reference fact: the masked KS counts over the padded width, so a
    block with a real +inf meets the pads.  Identical blocks [1..5, +inf]:
    the unpadded KS is 0, the masked KS at one pad column 1/6, in the
    reference and in the port alike."""
    x = np.array([1, 2, 3, 4, 5, np.inf], np.float32)
    xp = np.append(x, np.inf).astype(np.float32)
    col = np.arange(7) < 6
    j_static = float(jks.ks_statistic_many(jnp.asarray(x),
                                           jnp.asarray(x[None]))[0])
    j_masked = float(jks.ks_statistic_many_masked(
        jnp.asarray(xp), jnp.asarray(xp[None]), jnp.float32(6),
        jnp.asarray(col))[0])
    t_static = float(tks.ks_statistic_many(torch.from_numpy(x),
                                           torch.from_numpy(x[None]))[0])
    t_masked = float(tks.ks_statistic_many_masked(
        torch.from_numpy(xp[None]), torch.from_numpy(xp[None, None]),
        torch.tensor([6.0]), torch.from_numpy(col[None]))[0, 0])
    fused = float(ks_counts(torch.from_numpy(xp[None]),
                            torch.from_numpy(xp[None, None]),
                            torch.tensor([np.float32(1 / 6)]),
                            torch.from_numpy(col[None]))[0, 0])
    assert j_static == t_static == 0.0
    assert abs(j_masked - 1 / 6) <= KS_TOL and abs(t_masked - j_masked) \
        <= KS_TOL and abs(fused - j_masked) <= KS_TOL


def test_reference_arms_differ_on_a_grown_nan_row():
    """Reference fact: a row stored at width 5 with a NaN and grown to 6
    reads [1, 2, 3, 4, NaN, +inf].  Queried by [1, 2, 3, 4, NaN] (sorted
    with its pad: [1, 2, 3, 4, +inf, NaN]) the ``jax`` arm's binary search
    counts #{d <= +inf} = 4 and gives KS 0.2; the ``pallas`` arm's
    broadcast compares count 5 and give 0.  One step at d_crit 0.1: the
    reference arms and their port counterparts, miss and hit."""
    row = np.array([1, 2, 3, 4, np.nan, np.inf], np.float32)
    cand = np.array([1, 2, 3, 4, np.nan, np.inf], np.float32)  # raw, padded
    col = np.arange(6) < 5
    xs = np.sort(cand)
    j_ks = float(jks.ks_statistic_many_masked(
        jnp.asarray(xs), jnp.asarray(row[None]), jnp.float32(5),
        jnp.asarray(col))[0])
    t_ks = float(tks.ks_statistic_many_masked(
        torch.from_numpy(xs[None]), torch.from_numpy(row[None, None]),
        torch.tensor([5.0]), torch.from_numpy(col[None]))[0, 0])
    f_ks = float(ks_counts(torch.from_numpy(xs[None]),
                           torch.from_numpy(row[None, None]),
                           torch.tensor([np.float32(1 / 5)]),
                           torch.from_numpy(col[None]))[0, 0])
    assert abs(j_ks - 0.2) <= KS_TOL and abs(t_ks - j_ks) <= KS_TOL
    assert f_ks == 0.0
    # one step of each arm from a carry holding the row
    D = 8
    chan = tenc.chan_params([5], [0.1], [False], [False], "cpu")
    ref_chan = jenc._chan_params_host([5], [0.1], [False], [False])
    pallas = encode_step_pallas(
        jnp.asarray(xs), jnp.zeros((D, 6)).at[0].set(row),
        jnp.zeros(D).at[0].set(1.0), jnp.zeros(D).at[0].set(np.nan),
        jnp.zeros(D, bool).at[0].set(True), jnp.int32(1), jnp.asarray(True),
        d_crit=0.0, rel_tol=0.5, num_dict=D, use_minmax=False,
        chan=jenc._chan_block(ref_chan._replace(
            **{f: getattr(ref_chan, f)[0] for f in ref_chan._fields})),
        interpret=True)[-1]
    st = tenc.DictState(
        torch.zeros(1, D, 6).index_copy_(1, torch.tensor([0]),
                                         torch.from_numpy(row[None, None])),
        torch.zeros(1, D), torch.zeros(1, D), torch.arange(D)[None] == 0,
        torch.ones(1, dtype=torch.int32), torch.zeros(1, 0, 6))
    (hit_f, _, _), _ = k1.encode_scan_torch(
        torch.from_numpy(xs[None, None]), torch.ones(1, 1, dtype=torch.bool),
        st, d_crit=0.0, rel_tol=0.5, use_minmax=False, chan=chan.block())
    (hit_r, _, _), _ = tenc.encode_decisions_mixed(
        torch.from_numpy(cand[None, None]), num_dict=D, n_valid=[5],
        d_crit=[0.1], use_minmax=False, state=st)
    assert int(pallas[1]) == 1 and bool(hit_f[0, 0])     # pallas/fused: hit
    assert not bool(hit_r[0, 0])                         # jax/torch: miss


# ------------------------------------------------- the cohort
@pytest.mark.parametrize("matcher", ["reference", "fused"])
def test_cohort_lane_reset_and_grow(matcher):
    ours = MixedCohort(4, 2, rel_tol=0.1, matcher=matcher, device="cpu")
    ref = JaxCohort(4, 2, rel_tol=0.1, matcher=matcher)
    rng = np.random.default_rng(9)
    p = rng.normal(0, 1, (4, B)).astype(np.float32)
    steps = [
        [(0, p, 0.5, False, False), (1, p[:, :B - 1], 0.5, True, False)],
        "reset", "grow",
        [(3, p, 0.5, False, False), (1, p[::-1, 1:], 0.4, True, False)],
    ]
    for step in steps:
        if step == "reset":
            for co in (ours, ref):
                co.reset_lane(1)
            assert ours.lane_n[1] == 0
            assert not bool(ours.state.valid[1].any())
            assert int(ours.state.count[1]) == 0
        elif step == "grow":
            for co in (ours, ref):
                co.grow(4)
            assert ours.capacity == 4 and ours.state.valid.shape[0] == 4
        else:
            a, b = ours.decide(step), ref.decide(step)
            assert sorted(a) == sorted(b)
            for lane in a:
                for x, y in zip(a[lane], b[lane]):
                    _eq(x, y)
    assert ours.lane_n.tolist() == [B, B - 1, 0, B]
    assert ours.dispatches == 2
    _same_carry(ref.state, ours.state)


# ------------------------------------------------- adaptive sessions
SEL = dict(warmup_blocks=4, patience=2, min_dwell_blocks=16)


def _signals(C, n, seed=0):
    """Noise (stays std), a trend and a smooth wave (both switch)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    base = [rng.normal(0.0, 1.0, n),
            0.03 * t + rng.normal(0, 0.02, n),
            np.sin(t * 0.02) * 4 + rng.normal(0, 0.01, n)]
    return np.stack([base[ci % 3] for ci in range(C)])


def _session(port, backend, data, *, feed, eb=None, dtype=np.float64,
             **extra):
    kw = dict(mode="std", block_size=B, num_dict=8, backend=backend,
              adaptive=True, **extra)
    if eb is not None:
        kw["error_bound"] = eb
    if port:
        codec = IdealemCodec(device="cpu", selector=SelectorConfig(**SEL),
                             **kw)
    else:
        codec = JaxCodec(selector=JaxSelectorConfig(**SEL), **kw)
    s = codec.session(channels=data.shape[0], dtype=dtype)
    segs = [s.feed(data[:, lo:lo + feed])
            for lo in range(0, data.shape[1], feed)]
    segs.append(s.finish())
    return segs, s


ARMS = [("torch", "jax"), ("cuda", "pallas"), ("numpy", "numpy")]


@pytest.mark.parametrize("feed", [96, B * 40])
@pytest.mark.parametrize("eb", [None, 0.6])
@pytest.mark.parametrize("arm", ARMS, ids=[a[0] for a in ARMS])
def test_adaptive_session_matches_reference(arm, eb, feed):
    data = _signals(3, B * 40, seed=1)
    ours, so = _session(True, arm[0], data, feed=feed, eb=eb)
    ref, sr = _session(False, arm[1], data, feed=feed, eb=eb)
    assert ours == ref
    assert [st.as_dict() for st in so.stats] == \
        [st.as_dict() for st in sr.stats]
    if arm[0] != "numpy":
        assert so._mixed is not None
        # one dispatch per feed that completed a block
        assert so._mixed.dispatches == -(-data.shape[1] // feed)
    if feed < data.shape[1]:
        assert any(st.mode_switches for st in so.stats)


@pytest.mark.parametrize("arm", [("torch", "jax"), ("numpy", "numpy")])
def test_single_channel_session_matches_reference(arm):
    """A 1-D stream that turns from noise to a smooth wave (the reference
    test's regime signal), fed in chunks of 256."""
    x = np.concatenate([_noise(16 * 100, 3), _smooth(16 * 100, 4)])
    out = []
    for port, backend in ((True, arm[0]), (False, arm[1])):
        kw = dict(mode="std", block_size=16, num_dict=32, alpha=0.05,
                  backend=backend, adaptive=True)
        codec = (IdealemCodec(device="cpu", selector=SelectorConfig(**SEL),
                              **kw) if port else
                 JaxCodec(selector=JaxSelectorConfig(**SEL), **kw))
        s = codec.session()
        blob = b"".join([s.feed(x[lo:lo + 256])
                         for lo in range(0, len(x), 256)] + [s.finish()])
        out.append((blob, s.stats.as_dict()))
    assert out[0] == out[1]
    assert out[0][1]["mode_switches"] >= 1


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_loop_arm_matches_batched(monkeypatch, backend):
    data = _signals(3, B * 40, seed=2)
    monkeypatch.setenv("REPRO_ADAPTIVE_LOOP", "1")  # the reference's: ignored
    a, sa = _session(True, backend, data, feed=96, eb=0.6)
    assert sa._mixed is not None
    monkeypatch.setenv(_ADAPTIVE_LOOP_ENV, "1")
    b, sb = _session(True, backend, data, feed=96, eb=0.6)
    assert sb._mixed is None and sb._mixed_disabled
    assert a == b


def test_f16_channels_match_reference(monkeypatch):
    data = _signals(2, B * 30, seed=3).astype(np.float16)
    ours, so = _session(True, "torch", data, feed=96, dtype=np.float16)
    ref, _ = _session(False, "jax", data, feed=96, dtype=np.float16)
    assert ours == ref and so._mixed is not None
    monkeypatch.setenv(_ADAPTIVE_LOOP_ENV, "1")
    loop, _ = _session(True, "torch", data, feed=96, dtype=np.float16)
    assert loop == ours


def test_ops_matcher_takes_the_loop():
    data = _signals(2, B * 20, seed=4)
    ops, so = _session(True, "torch", data, feed=B * 20, matcher="ops")
    plain, sp = _session(True, "torch", data, feed=B * 20)
    ref, _ = _session(False, "jax", data, feed=B * 20, matcher="ops")
    assert so._mixed is None and so._mixed_disabled
    assert sp._mixed is not None
    assert ops == plain == ref


def test_heterogeneous_streams_decode_as_reference():
    data = _signals(3, B * 50, seed=5)
    segs, s = _session(True, "cuda", data, feed=128)
    assert any(st.mode_switches for st in s.stats)
    for ci in range(3):
        blob = b"".join(seg[ci] for seg in segs)
        want = jax_decode_stream(blob)
        assert len(want) == data.shape[1]
        for backend in ("numpy", "torch", "cuda"):
            got = decode_stream(blob, backend=backend, device="cpu")
            assert got.tobytes() == want.tobytes()


def test_adaptive_requires_streaming():
    codec = IdealemCodec(mode="std", block_size=16, adaptive=True,
                         device="cpu")
    with pytest.raises(ValueError, match="streaming-only"):
        codec.encode(_noise(256))
    with pytest.raises(ValueError, match="emit_segments"):
        codec.session(emit_segments=False)
