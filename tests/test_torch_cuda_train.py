"""The trainer on the card, at SMOKE size: a train step on the card against
the same step on the CPU from the same state, gradient compression's
decisions through K1 against K1's plain version, and gemma3's banded
forward against its unbanded chunk loop.  Marked ``cuda``; without a
card every test skips.

Run on a machine with a card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda_train.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.encoder import init_state  # noqa: E402
from repro_torch.kernels import encode_step as k1  # noqa: E402
from repro_torch.launch.train import build_batches  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.optim import gradcomp  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.fixture
def no_tf32():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = before


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "gemma3_27b"])
def test_train_step_on_the_card_matches_the_cpu(arch, dev, no_tf32):
    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32,
                                               attn_chunk=4)
    cpu = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda t: t.to(dev), cpu)
    step = make_train_step(cfg, lr=1e-3, microbatches=2)
    batch = build_batches(cfg, 1, 4, 32)[0]
    new_cpu, m_cpu = step(cpu, batch)
    new_card, m_card = step(card, batch)
    assert tree_leaves(new_card)[0].device.type == "cuda"
    for k in ("loss", "grad_norm"):
        assert abs(float(m_card[k]) - float(m_cpu[k])) <= 1e-4 * abs(
            float(m_cpu[k]))
    for a, b in zip(tree_leaves(new_card.params),
                    tree_leaves(new_cpu.params)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * max(
            1.0, float(b.abs().max()))


def test_gradcomp_decides_through_k1(dev):
    rng = np.random.default_rng(0)
    scales = np.repeat(rng.choice([1e-3, 2e-3, 5e-2], size=300), 256)
    flat = torch.from_numpy((rng.normal(size=scales.size) * scales)
                            .astype(np.float32))
    blocks = flat.reshape(-1, 256)
    d_crit = float(gradcomp.critical_distance(0.05, 256, 256))
    k1.launches = 0
    h, s = gradcomp._decide(blocks.to(dev), num_dict=32, d_crit=d_crit,
                            rel_tol=0.5)
    torch.cuda.synchronize()
    assert k1.launches == 1
    xs = torch.sort(blocks.to(dev), dim=-1).values[None]
    valid = torch.ones((1, xs.shape[1]), dtype=torch.bool, device=dev)
    st = init_state(32, 256, channels=1, device=dev)
    (ph, ps, _), _ = k1.encode_scan_torch(xs, valid, st, d_crit=d_crit,
                                          rel_tol=0.5)
    assert torch.equal(h, ph[0]) and torch.equal(s, ps[0])
    assert 0 < int(h.sum()) < h.numel()
    src = gradcomp.hit_sources(h, s)
    recon, m, _ = gradcomp._compress_flat(flat.to(dev), block=256,
                                          num_dict=32, d_crit=d_crit,
                                          rel_tol=0.5)
    assert torch.equal(recon, blocks.to(dev)[src].reshape(-1))
    assert 0.0 < float(m["hit_rate"]) < 1.0


def test_banded_forward_on_the_card_matches_the_chunk_loop(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((1, 4096, 8, 128), device=dev, generator=g,
                           dtype=torch.bfloat16) for _ in range(3))
    pos = torch.arange(4096, dtype=torch.int32, device=dev)
    banded = attn._flash_banded(q, k, v, pos, window=1024, chunk=1024)
    loop = attn._flash_chunks(q, k, v, pos, pos, causal=True, window=1024,
                              chunk=1024)
    assert float((banded.float() - loop.float()).abs().max()) <= 0.0625
