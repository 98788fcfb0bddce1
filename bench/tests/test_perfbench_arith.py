"""The benchmark's arithmetic on fixed inputs: busy and idle time from
device intervals, idle gaps by host span, percentiles and spreads, the
roofline readers, and K1's work count against a step-by-step replay."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench.harness import devtrace, kwork  # noqa: E402
from bench.harness.core import Readings, load_metric, percentile  # noqa: E402

METRICS = ROOT / "bench"


def _readings(**kw):
    base = dict(cell="c", kind="reads", config={"mode": "delta",
                                                "block_size": 112},
                traffic={}, setup_s=1.0, window=(10.0, 12.0))
    base.update(kw)
    return Readings(**base)


def test_union_and_gaps():
    iv = [(10.5, 11.0), (10.8, 11.2), (11.5, 11.6), (9.0, 10.1)]
    assert devtrace.union_seconds(iv, 10.0, 12.0) == pytest.approx(
        0.1 + 0.7 + 0.1)
    gaps = devtrace.idle_gaps(iv, 10.0, 12.0)
    assert gaps == [(10.1, 10.5), (11.2, 11.5), (11.6, 12.0)]
    assert devtrace.idle_gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_idle_time_goes_to_the_innermost_open_span():
    spans = {"session.prepare": [(10.15, 10.35)],
             "encode.flush": [(10.1, 10.6), (11.0, 11.55)]}
    gaps = [(10.1, 10.5), (11.2, 11.5), (11.6, 12.0)]
    got = devtrace.label_gaps(gaps, spans, ["session.prepare",
                                            "encode.flush"])
    assert got == pytest.approx({"session.prepare": 0.2,
                                 "encode.flush": 0.5, "harness": 0.4})
    assert devtrace.top_names({"a": 1.0, "b": 3.0}) == [["b", 3.0],
                                                        ["a", 1.0]]


def test_percentile():
    vals = list(range(1, 101))
    assert percentile(vals, 95) == 95
    assert percentile([3.0], 95) == 3.0


def test_idle_and_copy_readers():
    ev = [("encode_scan_kernel", 10.0, 10.5),
          ("Memcpy HtoD (Pageable -> Device)", 10.5, 10.6),
          ("Memcpy DtoH (Device -> Pageable)", 11.0, 11.1)]
    r = _readings(device_events=ev)
    assert load_metric(METRICS, "idle_share.read")(r) == pytest.approx(
        100 * (1 - 0.7 / 2.0))
    assert load_metric(METRICS, "idle_share.ingest")(r) == pytest.approx(
        100 * (1 - 0.7 / 2.0))
    assert load_metric(METRICS, "copy_share.read")(r) == pytest.approx(
        100 * 0.2 / 2.0)
    assert load_metric(METRICS, "idle_share.read")(_readings()) is None


def test_k2_roofline_reads_requested_rows_only():
    # 3 requests of 100, 28 and 1 blocks: 129 rows of 111 f64, in and out
    reqs = [(0, 1, 0, 100), (0, 1, 0, 28), (0, 1, 0, 1)]
    t_k2 = 1e-4
    r = _readings(requests=reqs,
                  device_events=[("void seq_cumsum_kernel<double>", 10.0,
                                  10.0 + t_k2)])
    want = 100 * (2 * 129 * 111 * 8 / 3.35e12) / t_k2
    assert load_metric(METRICS, "k2_roofline.read")(r) == pytest.approx(want)
    std = _readings(requests=reqs, config={"mode": "std", "block_size": 32})
    assert load_metric(METRICS, "k2_roofline.read")(std) is None


def test_k1_roofline_reader():
    work = {"bytes": 3.35e9, "ops": 67e9, "launches": 2}   # 1 ms each
    r = _readings(kind="ingest", work={"encode_scan": work},
                  device_events=[("encode_scan_kernel", 10.0, 10.002),
                                 ("encode_scan_kernel", 11.0, 11.002)])
    assert load_metric(METRICS, "k1_roofline.ingest")(r) == pytest.approx(
        100 * 1e-3 / 4e-3)
    assert kwork.least_seconds(3.35e9, 1.0) == (1e-3, "bytes")
    assert kwork.least_seconds(1.0, 67e9) == (1e-3, "operations")


def test_shares_from_host_and_registry():
    r = _readings(kind="ingest",
                  host_s={"session.prepare": 0.3, "session.commit": 0.2},
                  registry_delta={"repro_encode_flush_seconds.sum": 1.5})
    assert load_metric(METRICS, "session_share.ingest")(r) == pytest.approx(25)
    assert load_metric(METRICS, "decide_share.ingest")(r) == pytest.approx(50)
    r = _readings(registry_delta={
        "repro_serve_stage_seconds{stage=plan}.sum": 0.1,
        "repro_serve_stage_seconds{stage=gather}.sum": 0.3})
    assert load_metric(METRICS, "gather_share.read")(r) == pytest.approx(20)
    r = _readings(requests=[(0.0, 0.001 * k, 8, 1) for k in range(1, 101)])
    assert load_metric(METRICS, "read_p95_ms.read")(r) == pytest.approx(95)
    assert load_metric(METRICS, "read_MBps")(
        _readings(bytes_done=4_000_000)) == pytest.approx(2.0)
    assert load_metric(METRICS, "ingest_MBps")(
        _readings(bytes_done=4_000_000)) is None


def _replay(xmin, xmax, valid, hit, dmin0, dmax0, dvalid0, count0, r):
    """K1's gate rows counted one step at a time."""
    C, nb = xmin.shape
    D = dmin0.shape[1]
    rows = ks = 0
    for c in range(C):
        dmin, dmax = dmin0[c].copy(), dmax0[c].copy()
        dv, count = dvalid0[c].copy(), int(count0[c])
        for b in range(nb):
            if not valid[c, b]:
                continue
            t = (dmax - dmin) * np.float32(r)
            g = dv & (xmin[c, b] >= dmin - t) & (xmin[c, b] <= dmin + t) \
                & (xmax[c, b] >= dmax - t) & (xmax[c, b] <= dmax + t)
            rows += int(dv.sum())
            ks += int(g.sum())
            if not hit[c, b]:
                s = count % D
                dmin[s], dmax[s], dv[s] = xmin[c, b], xmax[c, b], True
                count += 1
    return rows, ks


def test_k1_work_matches_a_step_by_step_replay():
    rng = np.random.default_rng(4)
    C, nb, D, n = 3, 40, 5, 8
    xmin = rng.normal(0, 1, (C, nb)).astype(np.float32)
    xmax = (xmin + rng.uniform(0.5, 1.5, (C, nb))).astype(np.float32)
    valid = rng.random((C, nb)) < 0.85
    hit = (rng.random((C, nb)) < 0.6) & valid
    dmin0 = rng.normal(0, 1, (C, D)).astype(np.float32)
    dmax0 = (dmin0 + 1.0).astype(np.float32)
    dvalid0 = rng.random((C, D)) < 0.5
    count0 = np.array([0, 3, 7], dtype=np.int32)
    t = torch.from_numpy
    nbytes, ops = kwork.k1_flush_work(
        torch, t(xmin), t(xmax), t(valid), t(hit), t(dmin0), t(dmax0),
        t(dvalid0), t(count0), 0.5, n)
    rows, ks = _replay(xmin, xmax, valid, hit, dmin0, dmax0, dvalid0,
                       count0, 0.5)
    assert ops == rows * kwork.K1_GATE_OPS + ks * kwork.K1_KS_OPS_PER_SAMPLE * n
    assert nbytes == (int(valid.sum()) * n * 4 + C * nb
                      + 2 * C * (D * n * 4 + D * 9 + 4) + C * nb * 6)


def test_k1_capture_keeps_inputs_in_its_arena():
    """The traced run's copies of K1's inputs equal the inputs, strided
    and boolean ones too; past its slots it copies into fresh memory and
    counts the spill."""
    sys.path.insert(0, str(ROOT / "src"))
    from bench.harness.ingest import _K1Capture
    cap = _K1Capture(torch, on=True, slots=2)
    xs = torch.rand(4, 6, 5)
    parts = lambda: (xs[..., 0], xs[..., -1], torch.rand(4, 6) > 0.5,
                     torch.rand(4, 6) > 0.5, torch.rand(4, 3),
                     torch.rand(4, 3), torch.rand(4, 3) > 0.5,
                     torch.arange(4, dtype=torch.int32))
    for _ in range(3):
        src = parts()
        kept = cap._keep(src)
        cap.launches.append(kept)
        assert all(torch.equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(src, kept))
    assert cap.spilled == 1
    assert cap.arena.numel() == 2 * cap.slot_bytes
    lo = cap.arena.data_ptr()
    assert not lo <= kept[0].data_ptr() < lo + cap.arena.numel()
