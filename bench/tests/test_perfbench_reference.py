"""The benchmark's plain reference (``bench/reference/idealem_np.py``)
reproduces the golden corpus byte for byte, and the port's streams and
window decodes on small PMU-like traffic."""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]


def _reference():
    spec = importlib.util.spec_from_file_location(
        "perfbench_reference", ROOT / "bench" / "reference" / "idealem_np.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


R = _reference()

# A copy of the golden corpus's signal recipe (tests/conftest.py:
# lcg_signal, golden_signal, golden_codec_kwargs), kept here so that this
# check does not depend on the test suite's helpers.
_LCG_A, _LCG_C, _LCG_M = 6364136223846793005, 1442695040888963407, 2**64
GOLDEN = {
    "std_D1": dict(mode="std", num_dict=1),
    "std_D32": dict(mode="std", num_dict=32),
    "residual_D1": dict(mode="residual", num_dict=1),
    "residual_D32_vr": dict(mode="residual", num_dict=32,
                            value_range=(0.0, 360.0)),
    "delta_D1_vr": dict(mode="delta", num_dict=1, value_range=(0.0, 360.0)),
    "delta_D32": dict(mode="delta", num_dict=32),
    "std_D4_ovw": dict(mode="std", num_dict=4),
    "std_D8_f16": dict(mode="std", num_dict=8, dtype=np.float16),
}


def _lcg(n, seed, lo, hi):
    out = np.empty(n, dtype=np.float64)
    s = (seed * 2 + 1) & (_LCG_M - 1)
    for i in range(n):
        s = (_LCG_A * s + _LCG_C) % _LCG_M
        out[i] = s / _LCG_M
    return lo + out * (hi - lo)


def _golden_signal(name):
    idx = list(GOLDEN).index(name)
    vr = GOLDEN[name].get("value_range")
    lo, hi = vr if vr is not None else (-4.0, 4.0)
    x = _lcg(16 * 40 + 5, idx + 1, lo, hi)
    n_lvl, scale = (16, 0.9) if name.endswith("_ovw") else (5, 0.07)
    x += np.repeat(np.arange(n_lvl), len(x) // n_lvl + 1)[:len(x)] \
        * (hi - lo) * scale
    x = np.mod(x, hi - lo) + lo if vr is not None else x
    return x.astype(GOLDEN[name].get("dtype", np.float64))


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_reference_reproduces_golden_stream(name):
    cfg = {k: v for k, v in GOLDEN[name].items() if k != "dtype"}
    cfg.update(block_size=16, alpha=0.05, rel_tol=0.5)
    want = (ROOT / "tests" / "golden" / f"{name}.idlm").read_bytes()
    assert R.encode(cfg, _golden_signal(name)) == want


def _pmu(n, seed):
    rng = np.random.default_rng(seed)
    x = 7200.0 + rng.normal(0, 1.5, n)
    x[n // 3:] += 6.0
    return x


MAG = dict(mode="std", block_size=32, num_dict=255, alpha=0.01, rel_tol=0.5,
           value_range=None)
ANG = dict(mode="delta", block_size=112, num_dict=255, alpha=0.01,
           rel_tol=0.5, value_range=[0.0, 360.0])


@pytest.mark.parametrize("cfg", [MAG, ANG], ids=["mag", "ang-delta"])
def test_reference_session_matches_port_streams(cfg):
    """Chunked reference segments == the port's session segments on its
    plain tensor scan (the cuda kernel's decisions), f32 decisions and
    all."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import IdealemCodec
    x = _pmu(3000, 1) if cfg is MAG else np.mod(
        np.arange(6000) * 0.72 + np.random.default_rng(2).normal(0, .05, 6000),
        360.0)
    kw = {k: (tuple(v) if k == "value_range" and v else v)
          for k, v in cfg.items()}
    port = IdealemCodec(**kw, backend="torch", device="cpu").session()
    ref = R.Session(cfg)
    got, want = [], []
    for a in range(0, len(x), 1100):
        got.append(port.feed(x[a:a + 1100]))
        want.append(ref.feed(x[a:a + 1100]))
    got.append(port.finish())
    want.append(ref.finish())
    assert got == want


def test_reference_window_decode_matches_port():
    """Window decodes == the port's numpy decode of the reference's own
    stream (hit permutations keyed on the global block position)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.stream import decode_stream
    for cfg, x in ((MAG, _pmu(4000, 3)),
                   (ANG, np.mod(np.arange(4500) * 0.31, 360.0))):
        blob = R.encode(cfg, x)
        full = decode_stream(blob, seed=77, backend="numpy")
        chan = R.Channel(cfg, x)
        B = cfg["block_size"]
        for lo, hi in ((0, 3), (5, 17), (20, len(x) // B)):
            got = R.reconstruct(chan, lo, hi, seed=77)
            assert got.tobytes() == full[lo * B:hi * B].tobytes()


def test_control_precision_changes_every_stream():
    """The float32 control differs from the float64 reference."""
    x = _pmu(2000, 5)
    s64, s32 = R.Session(MAG), R.Session(MAG, dtype=np.float32)
    assert s64.feed(x) != s32.feed(x)
    chan64, chan32 = R.Channel(MAG, x), R.Channel(MAG, x, dtype=np.float32)
    a = R.reconstruct(chan64, 0, 10, seed=1)
    b = R.reconstruct(chan32, 0, 10, seed=1).astype(np.float64)
    assert np.count_nonzero(a != b) > 0
