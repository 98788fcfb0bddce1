"""The codec round trip of the PyTorch port vs the JAX reference, on the CPU.

Every comparison here is exact (bytes): stream bytes against the golden
corpus and the JAX session's segments, decoded samples against the JAX
package's ``decode_stream`` and the port's own host reconstruction.  The
``cuda`` backend with ``device="cpu"`` runs the kernels' plain versions.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import GOLDEN_CASES, golden_codec_kwargs, golden_signal  # noqa: E402
from repro.core import IdealemCodec as JaxCodec  # noqa: E402
from repro.core.stream import decode_stream as jax_decode_stream  # noqa: E402
from repro_torch import IdealemCodec, StreamFormatError  # noqa: E402
from repro_torch.core import decode as tdec  # noqa: E402
from repro_torch.core import encoder as tenc  # noqa: E402
from repro_torch.core.stream import decode_stream  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
ENCODE_BACKENDS = ["numpy", "torch", "cuda"]
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _golden_bytes(name):
    with open(os.path.join(GOLDEN_DIR, f"{name}.idlm"), "rb") as f:
        return f.read()


def _codec(backend="cuda", **kw):
    return IdealemCodec(backend=backend, device="cpu", **kw)


def _mixed(n, seed=0):
    rng = np.random.default_rng(seed)
    parts = [rng.normal(m, s, size=n // 3)
             for m, s in [(0, 1), (5, 0.5), (0, 1)]]
    return np.concatenate(parts + [rng.normal(0, 1, size=n - 3 * (n // 3))])


# --------------------------------------------------------- golden corpus
@pytest.mark.parametrize("backend", ENCODE_BACKENDS)
@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_golden_stream_reproduced(name, backend):
    kw = golden_codec_kwargs(name)
    kw["backend"] = backend
    codec = IdealemCodec(device="cpu", **kw)
    assert codec.encode(golden_signal(name)) == _golden_bytes(name)


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_golden_decode_matches_jax(name):
    blob = _golden_bytes(name)
    want = jax_decode_stream(blob, seed=5)
    for backend in tdec.BACKENDS:
        got = decode_stream(blob, seed=5, backend=backend, device="cpu")
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()


# ------------------------------------------------------------- streaming
@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("kw", [
    dict(mode="std", num_dict=8),
    dict(mode="residual", num_dict=8, value_range=(0.0, 360.0)),
    dict(mode="delta", num_dict=1),
    dict(mode="delta", num_dict=6, value_range=(0.0, 360.0)),
], ids=["std", "residual_vr", "delta_D1", "delta_vr"])
def test_chunked_feeds_decode_like_one_shot(kw, backend):
    codec = _codec(backend, block_size=16, alpha=0.05, rel_tol=0.5, **kw)
    x = _mixed(16 * 30 + 7, seed=1)
    if "value_range" in kw:
        x = np.mod(x * 40.0, 360.0)
    one_shot = codec.decode(codec.encode(x))
    s = codec.session()
    parts = [s.feed(x[i:i + 37]) for i in range(0, len(x), 37)]
    parts.append(s.finish())
    chunked = codec.decode(b"".join(parts))
    assert chunked.tobytes() == one_shot.tobytes()
    assert s.stats.blocks == 30 and 0 < s.stats.hits < 30


@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda"])
@pytest.mark.parametrize("mode", ["std", "delta"])
def test_multichannel_segments_equal_jax_session(mode, backend):
    C, m = 3, 80
    kw = dict(mode=mode, block_size=16, num_dict=5, alpha=0.05, rel_tol=0.5)
    x = np.stack([_mixed(5 * m + 3, seed=c) for c in range(C)])
    js = JaxCodec(backend="jax", **kw).session(channels=C)
    ts = _codec(backend, **kw).session(channels=C)
    for lo in range(0, x.shape[1], m):
        assert ts.feed(x[:, lo:lo + m]) == js.feed(x[:, lo:lo + m])
    assert ts.finish() == js.finish()
    assert [s.as_dict() for s in ts.stats] == [s.as_dict() for s in js.stats]


def test_f32_stream_matches_jax():
    x = _mixed(16 * 20 + 3, seed=4).astype(np.float32)
    kw = dict(mode="residual", block_size=16, num_dict=4, alpha=0.05,
              rel_tol=0.5)
    blob = _codec(**kw).encode(x)
    assert blob == JaxCodec(backend="numpy", **kw).encode(x)
    y = _codec(**kw).decode(blob)
    assert y.dtype == np.float32 and len(y) == len(x)
    np.testing.assert_array_equal(y[-3:], x[-3:])  # exact tail


# ---------------------------------------------------- device reconstruct
@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.float16])
@pytest.mark.parametrize("mode", [tdec.MODE_RESIDUAL, tdec.MODE_DELTA])
def test_device_reconstruct_bitwise_with_negative_zero(mode, dtype):
    rng = np.random.default_rng(9)
    B, nb, n_rows = 12, 40, 7
    payloads = rng.normal(0, 30, (n_rows, B - 1)).astype(dtype)
    payloads[:, 0] = -0.0
    bases = rng.uniform(0, 360, nb).astype(dtype)
    bases[:5] = -0.0
    src = rng.integers(0, n_rows, nb)
    for vr in (None, (0.0, 360.0)):
        plan = tdec.DecodePlan(
            mode=mode, block_size=B, dtype=np.dtype(dtype), value_range=vr,
            payloads=payloads, src=src, bases=bases,
            is_hit=np.arange(nb) >= n_rows,
            block_idx=np.arange(nb, dtype=np.int64))
        want = tdec.reconstruct(plan, "numpy")
        for backend in ("torch", "cuda"):
            got = tdec.reconstruct(plan, backend, device="cpu")
            assert got.tobytes() == want.tobytes()


def test_reconstruct_rejects_unknown_backend():
    plan = tdec.DecodePlan(0, 4, np.dtype(np.float64), None,
                           np.zeros((1, 4)), np.zeros(1, np.int64), None,
                           np.zeros(1, bool), np.zeros(1, np.int64))
    with pytest.raises(ValueError):
        tdec.reconstruct(plan, "pallas")


def test_truncated_stream_raises_typed_error():
    blob = _golden_bytes("std_D32")
    with pytest.raises(StreamFormatError) as e:
        decode_stream(blob[:100], device="cpu")
    assert isinstance(e.value, ValueError) and e.value.offset > 0


# ------------------------------------------------------- scope and device
def test_unported_options_raise():
    for kw in (dict(matcher="warp"), dict(backend="pallas"),
               dict(decode_backend="jax")):
        with pytest.raises(ValueError):
            _codec(**kw)
    with pytest.raises(ValueError, match="streaming-only"):
        _codec(adaptive=True).encode(np.zeros(64))
    # encode plans are ported: the port raises where the reference does,
    # on a plan made for another channel count and on a dictionary-sharded
    # plan for an adaptive session
    from repro_torch.launch.encode_plan import make_encode_plan
    codec = _codec()
    with pytest.raises(ValueError, match="plan is for 2 channels"):
        codec.session(plan=make_encode_plan(2, devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="dict_shards=1"):
        _codec(adaptive=True).session(plan=make_encode_plan(
            1, devices=["cpu"] * 2, dict_shards=2))
    with pytest.raises(ValueError, match="container output"):
        _codec(adaptive=True).session(container=True)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        IdealemCodec()
    plan = tdec.DecodePlan(0, 4, np.dtype(np.float64), None,
                           np.zeros((1, 4)), np.zeros(1, np.int64), None,
                           np.zeros(1, bool), np.zeros(1, np.int64))
    with pytest.raises(RuntimeError, match="CUDA"):
        tdec.reconstruct(plan, "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdec.reconstruct(plan)
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_stream(_golden_bytes("std_D32"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tenc.init_state(4, 8)


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15
