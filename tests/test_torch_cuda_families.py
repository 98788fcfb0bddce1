"""The other decode families on the card, at SMOKE size: one decode step a
family, with K4 launched once per self-attention layer (none for RWKV6),
its logits close to the plain attention core's, and the engine's greedy
tokens in range.  Marked ``cuda``; without a card every test skips.

Run on a machine with a card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda_families.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_decode as k4  # noqa: E402
from repro_torch.launch.serve import memory_len  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

pytestmark = pytest.mark.cuda

FAMILIES = ["granite_moe_1b_a400m", "mixtral_8x22b", "rwkv6_3b",
            "zamba2_1_2b", "llama_3_2_vision_90b", "whisper_tiny"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_decode_step_on_the_card(arch, dev):
    cfg = get_config(arch, smoke=True)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    M = memory_len(cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 3))).to(dev)
    attn_layers = sum(k in lm.SELF_ATTN_KINDS for k in lm.layer_kinds(cfg))
    assert (attn_layers == 0) == (cfg.family == "ssm")
    logits = {}
    for backend in ("cuda", "torch"):
        cache = lm.init_cache(cfg, 4, 16, M, device=dev)
        out = []
        k4.launches = 0
        for t in range(toks.shape[1]):
            lg, cache = lm.decode_step(params, cache, toks[:, t:t + 1], cfg,
                                       backend=backend)
            out.append(lg)
        torch.cuda.synchronize()
        want = attn_layers * toks.shape[1] if backend == "cuda" else 0
        assert k4.launches == want, (backend, k4.launches, want)
        logits[backend] = torch.cat(out, dim=1)
    assert logits["cuda"].shape == (4, 3, cfg.vocab_size)
    assert bool(torch.isfinite(logits["cuda"]).all())
    assert float((logits["cuda"] - logits["torch"]).abs().max()) < 0.05
    eng = ServeEngine(cfg, params, max_seq=16, memory_len=M)
    got = eng.generate(toks[:, :2].cpu().numpy(), 3)
    assert got.shape == (4, 3) and got.min() >= 0 \
        and got.max() < cfg.vocab_size
