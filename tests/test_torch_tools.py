"""The port's operator tools and load generator on the CPU.

``python -m repro_torch.launch.{store_tool,obs_tool,autotune_tool,loadgen}``
run in process with ``--device cpu``: ``store_tool bigcheck``/``inspect``
as ``tests/test_store.py`` runs the reference's, ``selfcheck`` over the
golden corpus, ``obs_tool selfcheck`` and ``slo``, ``autotune_tool
probe``/``selfcheck`` and ``loadgen --smoke``.  Where the reference's
script prints the same thing (``store_tool inspect``, ``obs_tool slo``)
the two outputs and exit codes must be equal.
"""
import contextlib
import importlib
import io
import json
import os
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from conftest import GOLDEN_BLOCK  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.stream import decode_stream  # noqa: E402
from repro_torch.launch import (autotune_tool, loadgen, obs_tool,  # noqa: E402
                                store_tool)

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden")


def _run(main, argv):
    """``(exit code, stdout)`` of ``main(argv)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@contextlib.contextmanager
def reference_script(name):
    scripts = os.path.join(HERE, "..", "scripts")
    sys.path.insert(0, scripts)
    try:
        yield importlib.import_module(name)
    finally:
        sys.path.remove(scripts)


# -------------------------------------------------------------- store_tool
def test_store_tool_bigcheck_and_inspect(tmp_path):
    """The >RAM-budget synthetic archive end to end, size-capped, read on
    ``cuda`` (its plain version here); ``inspect`` prints what the
    reference's prints for the same file."""
    out = str(tmp_path / "big.idlmc")
    rc, text = _run(store_tool.main, [
        "bigcheck", "--mb", "1", "--channel-blocks", "256", "--mmap",
        "--out", out, "--device", "cpu"])
    assert rc == 0, text
    assert "bigcheck passed" in text and "cuda/cpu" in text
    assert os.path.getsize(out) > 1e6
    rc, text = _run(store_tool.main, ["inspect", out, "--mmap", "--chunks"])
    assert rc == 0
    with reference_script("store_tool") as ref:
        jrc, jtext = _run(ref.main, ["inspect", out, "--mmap", "--chunks"])
    assert (rc, text) == (jrc, jtext)


@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda"])
def test_store_tool_pack_selfcheck_extract_golden(tmp_path, backend):
    streams = sorted(os.path.join(GOLDEN, f) for f in os.listdir(GOLDEN)
                     if f.endswith(".idlm"))
    rc, text = _run(store_tool.main, ["selfcheck", *streams, "--mmap",
                                      "--backend", backend,
                                      "--device", "cpu"])
    assert rc == 0, text
    assert text.count(" ok\n") == len(streams)
    out = str(tmp_path / "g.idlmc")
    rc, _ = _run(store_tool.main, ["pack", out, *streams[:3]])
    assert rc == 0
    npy = str(tmp_path / "r.npy")
    rc, _ = _run(store_tool.main, ["extract", out, "--channel", "2",
                                   "--blocks", "3:9", "-o", npy,
                                   "--backend", backend, "--device", "cpu"])
    assert rc == 0
    with open(streams[2], "rb") as f:
        y = decode_stream(f.read(), backend="numpy")
    B = GOLDEN_BLOCK
    assert np.load(npy).tobytes() == y[3 * B:9 * B].tobytes()


# ---------------------------------------------------------------- obs_tool
def test_obs_tool_selfcheck_on_the_host():
    rc, text = _run(obs_tool.main, ["selfcheck", "--device", "cpu"])
    assert rc == 0, text
    assert "exporter round trip: OK" in text
    assert "live end-to-end on cpu: OK" in text


def test_obs_tool_slo_equals_the_reference(tmp_path):
    """SLO specs over a scrape of the port's registry: the port's tool and
    the reference's print the same verdicts and exit codes."""
    reg = obs.MetricsRegistry()
    h = reg.histogram("repro_frontend_request_seconds", "wall",
                      labels={"route": "POST /v1/feed"})
    for v in (0.001, 0.002, 0.004, 0.3, 0.02):
        h.observe(v)
    scrape = tmp_path / "scrape.prom"
    scrape.write_text(obs.to_prometheus(reg))
    cases = [
        ["repro_frontend_request_seconds:0.99:0.5:route=POST /v1/feed"],
        ["repro_frontend_request_seconds:0.5:0.001:route=POST /v1/feed"],
        ["repro_frontend_request_seconds:0.99:1:route=POST /v1/decode",
         "--require-traffic"],
        ["repro_frontend_request_seconds:0.99"],
    ]
    seen = set()
    with reference_script("obs_tool") as ref:
        for spec in cases:
            argv = ["slo", str(scrape), *spec]
            got = _run(obs_tool.main, argv)
            assert got == _run(ref.main, argv), spec
            seen.add(got[0])
    assert seen == {0, 1, 2}


# ----------------------------------------------------------- autotune_tool
def test_autotune_tool_probe_then_selfcheck(tmp_path, monkeypatch):
    from repro_torch.core import decode as decode_mod
    path = tmp_path / "at.json"
    monkeypatch.setenv("REPRO_TORCH_DECODE_AUTOTUNE", str(path))
    monkeypatch.delenv("REPRO_DECODE_AUTOTUNE", raising=False)
    try:
        rc, text = _run(autotune_tool.main, [
            "probe", "--device", "cpu", "--buckets", "64,256"])
        assert rc == 0, text
        doc = json.loads(path.read_text())
        assert len(doc["entries"]) == 6
        assert all(k.endswith("|device=cpu") for k in doc["entries"])
        assert all(e["backend"] in ("numpy", "torch", "cuda")
                   for e in doc["entries"].values())
        rc, text = _run(autotune_tool.main, ["selfcheck", str(path)])
        assert rc == 0, text
        assert text.count("rejected as expected") == 3
        assert text.count("lenient load discarded it") == 3
        # an empty table is a failed check
        empty = tmp_path / "empty.json"
        empty.write_text(json.dumps({"version": doc["version"],
                                     "entries": {}}))
        rc, text = _run(autotune_tool.main, ["selfcheck", str(empty)])
        assert rc == 1 and "no entries" in text
    finally:
        decode_mod.reset_autotune()


# ----------------------------------------------------------------- loadgen
def test_loadgen_smoke_on_the_host(tmp_path):
    report = tmp_path / "loadgen.json"
    rc, text = _run(loadgen.main, ["--smoke", "--device", "cpu",
                                   "--json", str(report)])
    assert rc == 0, text
    doc = json.loads(report.read_text())
    assert doc["ok"] and not doc["problems"]
    assert doc["byte_diffs"] == 0 and doc["decode_diffs"] == 0
    assert doc["rejections_seen"] >= 1 and \
        doc["metrics_rejections_total"] >= 1
    assert len(doc["tenants"]) == 9 and doc["config"]["device"] == "cpu"
    assert {s["ok"] for s in doc["slos"]} == {True}


def test_loadgen_configs_follow_the_device():
    direct, coal = loadgen.configs("cuda")
    assert (direct.backend, direct.decode_backend) == ("cuda", "cuda")
    assert (coal.backend, coal.mode) == ("cuda", "residual")
    direct, coal = loadgen.configs("cpu")
    assert (direct.backend, coal.backend) == ("torch", "torch")
