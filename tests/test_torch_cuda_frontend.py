"""The port's front end on the card: one tenant's direct and coalesced
streams over the wire with ``device="cuda"``; the direct stream's bytes
equal a ``cuda`` shadow session fed the same chunks, each direct feed that
holds a whole block is one K1 launch, the coalesced stream decodes like
the one-shot encode, and a delta container's range reads through the
decode mux launch K2.  Marked ``cuda``; without a card every test skips.

Run on a machine with a card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda_frontend.py``.
"""
import asyncio

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.core import IdealemCodec  # noqa: E402
from repro_torch.kernels import encode_step as k1  # noqa: E402
from repro_torch.kernels import seq_cumsum as k2  # noqa: E402
from repro_torch.serve import (FlushPolicy, FrontendClient,  # noqa: E402
                               ServeFrontend)
from repro_torch.store import pack  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def test_direct_and_coalesced_streams_on_the_card(dev):
    cfg = api.CodecConfig(mode="residual", block_size=16, num_dict=31,
                          alpha=0.05, rel_tol=0.5)
    rng = np.random.default_rng(19)
    x = np.cumsum(rng.normal(0, 0.1, 16 * 300 + 7))
    chunks = [x[i:i + 150] for i in range(0, len(x), 150)]

    async def main():
        policy = FlushPolicy(max_batch_blocks=10**6, max_batch_streams=10**6,
                             max_age_s=None)
        async with ServeFrontend(policy=policy, run_control=False,
                                 tick_interval_s=None) as fe:
            assert fe.device.type == "cuda"
            async with FrontendClient(fe.host, fe.port, "gpu") as c:
                await c.open("d", cfg)
                await c.open("c", cfg, coalesce=True)
                k1.launches = 0
                direct = [(await c.feed("d", ch)).segment for ch in chunks]
                feeds_launched = k1.launches
                coal = [(await c.feed("c", ch)).segment for ch in chunks]
                assert k1.launches == feeds_launched  # staged, no flush yet
                direct.append((await c.close_stream("d")).segment)
                coal.append((await c.close_stream("c")).segment)
                assert k1.launches == feeds_launched + 1  # the close flush
            return feeds_launched, b"".join(direct), b"".join(coal)

    launched, direct, coal = asyncio.run(main())
    codec = IdealemCodec.from_config(cfg, device=dev)
    shadow = codec.session()
    want = b"".join([shadow.feed(ch) for ch in chunks] + [shadow.finish()])
    assert direct == want
    seen, whole = 0, 0
    for ch in chunks:  # a feed launches K1 when a whole block is ready
        seen += len(ch)
        whole += (seen // 16) > ((seen - len(ch)) // 16)
    assert launched == whole
    assert codec.decode(coal).tobytes() == codec.decode(
        codec.encode(x)).tobytes()


def test_delta_range_reads_launch_k2(dev):
    cfg = api.CodecConfig(mode="delta", block_size=16, num_dict=31,
                          value_range=(0.0, 360.0))
    x = np.mod(np.cumsum(np.full(16 * 200, 0.7)), 360.0)
    codec = IdealemCodec.from_config(cfg, device=dev)
    blob = codec.encode(x)
    y = codec.decode(blob, backend="numpy")

    async def main():
        async with ServeFrontend(run_control=False) as fe:
            async with FrontendClient(fe.host, fe.port, "gpu") as c:
                await c.attach("st", pack(blob))
                k2.launches = 0
                got = [await c.decode("st", i, i + 9, request_id=f"r{i}")
                       for i in range(0, 180, 30)]
                return got, k2.launches

    got, launches = asyncio.run(main())
    assert launches >= 1
    for i, rr in zip(range(0, 180, 30), got):
        assert rr.values.tobytes() == y[i * 16:(i + 9) * 16].tobytes()
