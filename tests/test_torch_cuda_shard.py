"""The scale-out encode on the card: a dictionary-sharded MAG scan with both
shards on ``cuda:0`` (K3 once a shard a block step) equals the unplanned
fused scan (K1) bit for bit, and a channel-sharded session launches K1
once a shard a feed with the unplanned session's bytes.  Marked ``cuda``;
without a card every test skips.

Run on a machine with a card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda_shard.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import IdealemCodec  # noqa: E402
from repro_torch.core import encoder as tenc  # noqa: E402
from repro_torch.kernels import dict_match as k3  # noqa: E402
from repro_torch.kernels import encode_step as k1  # noqa: E402
from repro_torch.launch.encode_plan import make_encode_plan  # noqa: E402

pytestmark = pytest.mark.cuda

# the paper's MAG configuration (Table I)
MAG = dict(mode="std", block_size=32, num_dict=255, alpha=0.01, rel_tol=0.5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _mag(C, nb, seed):
    """Blocks of seeded levels (more than D of them, so the FIFO turns
    over), a fifth repeating one of the 39 blocks before."""
    rng = np.random.default_rng(seed)
    x = rng.normal(rng.integers(0, 384, (C, nb, 1)) * 4.0, 1.0,
                   (C, nb, MAG["block_size"]))
    back = rng.integers(1, 40, (C, nb))
    for c in range(C):
        for b in range(1, nb):
            if rng.random() < 0.2 and back[c, b] <= b:
                x[c, b] = x[c, b - back[c, b]]
    return x


def test_dsharded_mag_scan_equals_fused_scan(dev):
    codec = IdealemCodec(device=dev, **MAG)
    C, nb = 16, 600
    blocks = torch.as_tensor(_mag(C, nb, seed=0), dtype=torch.float32,
                             device=dev)
    kw = dict(num_dict=codec.num_dict, d_crit=codec.d_crit,
              rel_tol=codec.rel_tol)
    st = tenc.init_state(codec.num_dict, 32, channels=C, device=dev)
    k1.launches = 0
    want, want_state = tenc.encode_decisions_batched(
        blocks, matcher="fused", state=st, **kw)
    assert k1.launches == 1
    k1.launches = k3.launches = 0
    got, sh = tenc.encode_decisions_dsharded(
        blocks, grid=[[dev, dev]], matcher="fused", state=st, **kw)
    torch.cuda.synchronize()
    assert (k3.launches, k1.launches) == (2 * nb, 0)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    joined = tenc.join_state(sh)
    for f in tenc.DictState._fields:
        a, b = getattr(want_state, f), getattr(joined, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f
    assert bool((joined.count > codec.num_dict).all())  # the FIFO wrapped
    assert [s.sorted_blocks.shape[1] for s in sh.grid[0]] == [128, 128]


def test_channel_sharded_session_launches_k1_per_shard(dev):
    codec = IdealemCodec(device=dev, **MAG)
    x = _mag(6, 256, seed=1).reshape(6, -1)
    plan = make_encode_plan(6, devices=[dev] * 4)   # 4 shards, 8 channels
    parts = {}
    for name, p in (("plain", None), ("planned", plan)):
        s = codec.session(channels=6, plan=p)
        k1.launches = 0
        segs = [s.feed(x[:, :4096]), s.feed(x[:, 4096:]), s.finish()]
        parts[name] = ([b"".join(seg[c] for seg in segs) for c in range(6)],
                       k1.launches)
    assert parts["planned"][0] == parts["plain"][0]
    assert (parts["plain"][1], parts["planned"][1]) == (2, 2 * 4)
