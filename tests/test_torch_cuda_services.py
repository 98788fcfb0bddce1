"""The serving services on the card: a ``StreamCoalescer`` flush is one K1
launch and equals per-stream sessions; a depth-2 ``DecompressionService``
flush on a delta container is one K2 launch a unit, answered from the
worker thread bitwise as the host decode.  Marked ``cuda``; without a card
every test skips.

Run on a machine with a card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda_services.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import golden_codec_kwargs, golden_signal  # noqa: E402
from repro_torch import IdealemCodec  # noqa: E402
from repro_torch.core.stream import decode_stream  # noqa: E402
from repro_torch.kernels import encode_step as k1  # noqa: E402
from repro_torch.kernels import seq_cumsum as k2  # noqa: E402
from repro_torch.serve import (DecompressionService, FlushPolicy,  # noqa: E402
                               StreamCoalescer)
from repro_torch.store import pack  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def test_coalescer_flush_is_one_k1_launch(dev):
    kw = dict(mode="residual", block_size=16, num_dict=31, alpha=0.05,
              rel_tol=0.5)
    rng = np.random.default_rng(3)
    xs = {f"s{i}": rng.normal(i, 1.0, size=16 * 50 + 3 * i)
          for i in range(5)}
    co = StreamCoalescer(policy=FlushPolicy(max_batch_streams=5),
                         capacity=2, device=dev, **kw)
    for sid in xs:
        co.open_stream(sid)
    k1.launches = 0
    res = None
    for sid, x in xs.items():
        res = co.submit(sid, x[:16 * 20 + 5])
    assert set(res) == set(xs) and k1.launches == 1 and co.capacity == 8
    codec = IdealemCodec(device=dev, **kw)
    for sid, x in xs.items():
        assert res[sid] == codec.session().feed(x[:16 * 20 + 5])
    assert k1.launches == 1 + len(xs)  # and one for each session's feed


def test_depth2_service_flush_is_one_k2_launch(dev):
    kw = golden_codec_kwargs("delta_D32")
    x = golden_signal("delta_D32")
    s = IdealemCodec(**kw).session()
    blob = b"".join([s.feed(x[lo:lo + 100]) for lo in range(0, len(x), 100)]
                    + [s.finish()])
    y = decode_stream(blob, backend="numpy")
    svc = DecompressionService(
        policy=FlushPolicy(max_batch_streams=3, pipeline_depth=2),
        device=dev)
    svc.attach("a", pack(blob))
    svc.attach("b", pack(blob))
    reqs = [("r0", "a", 0, 4), ("r1", "b", 10, 12), ("r2", "a", 3, 40)]
    k2.launches = 0
    out = {}
    for rid, sid, i, j in reqs:
        out.update(svc.submit(rid, sid, i, j) or {})
    out.update(svc.close())
    assert k2.launches == svc.stats["dispatches"] == 1
    for rid, _, i, j in reqs:
        assert out[rid].tobytes() == y[i * 16:j * 16].tobytes()
