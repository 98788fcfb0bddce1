"""The port's dry run (``repro_torch.launch.dryrun``) and its per-chip cost
counter (``repro_torch.launch.hlo_cost``).

The counter is exact on the reference test's two known programs
(``tests/test_hlo_cost.py``); its ring model, byte rules and K4's reckoned
cost are held to their formulas.  Tracing one and two repeats of each
stage (and two and three microbatches) and extrapolating gives the same
counts as tracing every layer (in a subprocess owning its fake process
group).  The counted operations' log gives the same counts again
(``launch/reanalyze.py``).
The reference's four dry-run cells run through the port's command line in
``tests/test_torch_dryrun_cells.py``.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.hlo_cost import (CostCounter, analyze,  # noqa: E402
                                         ring_wire_bytes)
from repro_torch.models.lm import stage_plan  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


def _loop(xs, w):
    c = xs[0]
    for x in xs:
        c = c @ w + x @ w
    return c


def _nested(xs, w):
    c = xs[0]
    for x in xs:
        c2 = c + x
        for _ in range(3):
            c2 = c2 @ w
        c = c2
    return c


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_counter_exact_on_known_programs(device):
    xs = torch.zeros(5, 64, 64, device=device)
    w = torch.zeros(64, 64, device=device)
    res, _ = analyze(_loop, xs, w)
    assert res["flops"] == 2 * 2 * 5 * 64 ** 3
    res2, _ = analyze(_nested, xs, w)
    assert res2["flops"] == 5 * 3 * 2 * 64 ** 3
    assert res["bytes"] > 0 and res["collectives"] == {}


def test_ring_model_units():
    size, n = 4096.0, 16
    assert ring_wire_bytes("all-reduce", size, n) == 2 * 15 / 16 * size
    assert ring_wire_bytes("all-gather", size, n) == 15 / 16 * size
    assert ring_wire_bytes("reduce-scatter", size, n) == 15 * size
    assert ring_wire_bytes("all-to-all", size, n) == 15 / 16 * size
    assert ring_wire_bytes("collective-permute", size, n) == size
    for kind in ("all-reduce", "all-gather", "reduce-scatter"):
        assert ring_wire_bytes(kind, size, 1) == 0.0
    with pytest.raises(ValueError):
        ring_wire_bytes("broadcast", size, n)


def test_counter_byte_rules():
    """Views and allocations move nothing; an operation moves its operands
    and results (an in-place result once); gathers twice their result,
    scatters twice their update."""
    t = torch.zeros(8, 16, device="meta")
    idx = torch.zeros(4, dtype=torch.int64, device="meta")
    with CostCounter() as c:
        t.view(16, 8).transpose(0, 1)
        torch.empty(100, device="meta")
    assert c.bytes == 0 and c.flops == 0
    with CostCounter() as c:
        t + t
    assert c.bytes == 3 * 8 * 16 * 4
    with CostCounter() as c:
        t.add_(1.0)
    assert c.bytes == 8 * 16 * 4
    with CostCounter() as c:
        t[idx]
    assert c.bytes == 2 * 4 * 16 * 4
    upd = torch.zeros(4, 16, device="meta")
    with CostCounter() as c:
        t.index_put_((idx,), upd, accumulate=True)
    assert c.bytes == 2 * 4 * 16 * 4


def test_events_count_again_through_json():
    """Each counted operation's event, written as JSON and read back,
    gives the trace's counts again (``hlo_cost.event_cost``): products,
    views, in-place results, gathers, tensor and scalar scatters, K4's
    reported cost."""
    from repro_torch.launch.hlo_cost import Tally
    t = torch.zeros(8, 16, device="meta")
    idx = torch.zeros(4, dtype=torch.int64, device="meta")
    upd = torch.zeros(4, 16, device="meta")
    q = torch.empty(2, 4, 16, device="meta")
    k = torch.empty(2, 8, 2, 16, dtype=torch.bfloat16, device="meta")
    valid = torch.empty(8, dtype=torch.bool, device="meta").expand(2, 8)
    log = []
    with CostCounter(log=log) as c:
        (t @ t.T).add_(1.0).view(64).sum()
        t[idx]
        t.index_put_((idx,), upd, accumulate=True)
        t.scatter(0, idx[:, None].expand(4, 16), 2.0)
        torch.bmm(q, q.transpose(1, 2))
        fd.flash_decode(q, k, k, valid)
    again = Tally()
    for ev in json.loads(json.dumps(log)):
        again.add_event(ev)
    assert again.result() == c.result()
    assert c.flops > 0 and c.bytes > 0


def test_reanalyze_reproduces_a_cli_cell(tmp_path):
    """A SMOKE cell written by the command line, its counted fields
    zeroed, comes back from ``python -m repro_torch.launch.reanalyze``
    exactly as the trace wrote it (from its ``.ops.jsonl.gz``)."""
    out = _run(["-m", "repro_torch.launch.dryrun", "--smoke", "--arch",
                "zamba2-1.2b", "--shape", "decode_32k", "--mesh", "single",
                "--out", str(tmp_path)], timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    jf = tmp_path / "zamba2_1_2b_decode_32k_single.json"
    assert (tmp_path / "zamba2_1_2b_decode_32k_single.ops.jsonl.gz").exists()
    rec = json.loads(jf.read_text())
    jf.write_text(json.dumps(dict(
        rec, flops_per_chip=0.0, bytes_per_chip=0.0, collectives={},
        collective_wire_bytes_per_chip=0.0, replication=0.0)))
    ra = _run(["-m", "repro_torch.launch.reanalyze", str(tmp_path)],
              timeout=120)
    assert ra.returncode == 0, ra.stderr[-2000:]
    assert "reanalyzed zamba2_1_2b_decode_32k_single.json" in ra.stdout
    assert json.loads(jf.read_text()) == rec


def test_counter_device_filter():
    """``device_type`` counts the operations on that device type only."""
    a = torch.zeros(4, 4)
    with CostCounter("meta") as c:
        a @ a
    assert c.flops == 0 and c.bytes == 0
    with CostCounter("cpu") as c:
        a @ a
    assert c.flops == 2 * 4 ** 3


def test_flash_decode_meta_reports_its_cost():
    """K4 on meta tensors launches nothing, returns an empty (B, H, hd)
    float32 output and reports 4*B*H*C*hd FLOPs and its operands' and
    output's bytes (the cache in its own dtype) to the active counter."""
    B, H, Hkv, C, hd = 3, 8, 2, 40, 16
    q = torch.empty(B, H, hd, device="meta")
    k = torch.empty(B, C, Hkv, hd, dtype=torch.bfloat16, device="meta")
    v = torch.empty_like(k)
    valid = torch.empty(C, dtype=torch.bool, device="meta").expand(B, C)
    before = fd.launches
    with CostCounter() as c:
        out = fd.flash_decode(q, k, v, valid)
    assert out.shape == (B, H, hd) and out.dtype == torch.float32
    assert out.device.type == "meta" and fd.launches == before
    assert c.flops == 4 * B * H * C * hd
    assert c.bytes == (B * H * hd * 4 + 2 * B * C * Hkv * hd * 2 + B * C
                       + B * H * hd * 4)
    assert fd.cost(q, k, v, valid) == (c.flops, c.bytes)


@pytest.mark.parametrize("arch", ARCHS)
def test_probes_span_the_full_plan(arch):
    """A stage plan of k stages gets k + 1 probes of the same patterns at
    few repeats, affinely independent, each repeat count within the full
    one's."""
    import numpy as np
    cfg = get_config(arch)
    pats, full = dryrun._plan(cfg)
    probes = dryrun._probes(cfg)
    assert len(probes) == len(full) + 1
    rows = [(1,) + v for v, _ in probes]
    assert np.linalg.matrix_rank(np.array(rows)) == len(rows)
    for v, c in probes:
        assert dryrun._plan(c) == (pats, list(v))
        assert sum(v) <= 2 * sum(len(p) for p in pats) + len(full) + 2
    assert [p for p, _ in stage_plan(cfg)] == pats


def test_extrapolation_refuses_negative_counts():
    """A count that extrapolates below 0 (not linear in the repeats) fails
    the cell instead of being recorded."""
    from fractions import Fraction
    flat = {"flops": Fraction(1), "bytes": Fraction(1),
            "argument_size_in_bytes": Fraction(1),
            "output_size_in_bytes": Fraction(1),
            "all-to-all.count": Fraction(-2),
            "all-to-all.wire_bytes": Fraction(-10)}
    with pytest.raises(ValueError, match="below 0"):
        dryrun._unflat(flat)
    flat.update({"all-to-all.count": Fraction(2),
                 "all-to-all.wire_bytes": Fraction(10)})
    assert dryrun._unflat(flat)["collectives"] == {
        "all-to-all": {"count": 2, "wire_bytes": 10.0}}


def _run(args, timeout):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, timeout=timeout, env=env,
                          cwd=os.path.dirname(SRC))


TRACE_ALL = r"""
import json
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import batch_axes, make_production_mesh
dryrun._fake_group(256)
mesh = make_production_mesh()
cells = [("zamba2_1_2b", ShapeSpec("p", 32, 32, "prefill"), 0),
         ("whisper_tiny", ShapeSpec("t", 16, 64, "train"), 2),
         ("granite_moe_1b_a400m", ShapeSpec("t", 16, 64, "train"), 4),
         ("gemma3_27b", ShapeSpec("d", 64, 1, "decode"), 0),
         ("llama_3_2_vision_90b", ShapeSpec("d", 64, 32, "decode"), 0)]
out = {}
for arch, shape, mb in cells:
    cfg = get_config(arch, smoke=True)
    one = dryrun.count_cell(cfg, shape, mesh, batch_axes(), mb)
    every = dryrun.count_cell(cfg.replace(scan_layers=False), shape, mesh,
                              batch_axes(), mb)
    out[arch] = [one, every]
print("RESULT " + json.dumps(out))
"""


def test_trace_one_repeat_equals_trace_all():
    """``scan_layers=True`` (trace k + 1 probes of one or two repeats a
    stage, two and three microbatches, and extrapolate) against
    ``scan_layers=False`` (trace every layer and microbatch) on SMOKE
    configs at small shapes on the (16, 16) fake mesh: FLOPs, bytes,
    collective counts and argument and output bytes equal; wire bytes
    (sums of (n-1)/n fractions in float64) within 1e-12 relative.  Cells:
    two stages (zamba2), an encoder (whisper), microbatches (the MoE,
    whisper), a sequence-sharded cache (gemma3 at batch 1), the VLM's
    cross caches."""
    out = _run(["-c", TRACE_ALL], timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT")]
    res = json.loads(line[0][len("RESULT "):])
    for arch, (one, every) in res.items():
        for key in ("flops", "bytes", "argument_size_in_bytes",
                    "output_size_in_bytes"):
            assert one[key] == every[key], (arch, key, one[key], every[key])
        assert one["flops"] > 0
        assert set(one["collectives"]) == set(every["collectives"]), arch
        for kind, d in every["collectives"].items():
            assert one["collectives"][kind]["count"] == d["count"], (arch,
                                                                     kind)
            assert one["collectives"][kind]["wire_bytes"] == pytest.approx(
                d["wire_bytes"], rel=1e-12), (arch, kind)
