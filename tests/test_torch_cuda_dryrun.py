"""The dry run's cost counter against the card, at SMOKE depth: the counter
around a meta trace of a step and around the same step on the card count
the same FLOPs and bytes -- the decode step (K4 launched once a
self-attention layer, reporting its reckoned cost as its meta branch
does) and a MoE train step.  The decode's arguments (parameters and cache)
reckoned on meta equal what the card's allocator grew by, within its
rounding of 512 bytes an allocation.  Marked ``cuda``; without a card
every test skips.

Run on a machine with a card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda_dryrun.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_decode as k4  # noqa: E402
from repro_torch.launch.hlo_cost import CostCounter  # noqa: E402
from repro_torch.launch.train import build_batches  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("arch", ["granite_3_8b", "granite_moe_1b_a400m",
                                  "zamba2_1_2b"])
def test_decode_meta_trace_counts_the_card_step(arch, dev):
    cfg = get_config(arch, smoke=True)
    B, C = 4, 64
    params = lm.init_params(cfg, device="meta")
    cache = lm.init_cache(cfg, B, C, device="meta")
    arg_bytes = sum(t.numel() * t.element_size()
                    for t in _tensors((params, cache)))
    n_args = len(_tensors((params, cache)))
    tokens = torch.zeros((B, 1), dtype=torch.int64, device="meta")
    with CostCounter("meta") as meta:
        lm.decode_step(params, cache, tokens, cfg, backend="cuda")
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    cache = lm.init_cache(cfg, B, C, device=dev)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - m0
    assert 0 <= grown - arg_bytes <= 512 * n_args
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, 1))).to(dev)
    k4.launches = 0
    with CostCounter("cuda") as real:
        logits, _ = lm.decode_step(params, cache, tokens, cfg,
                                   backend="cuda")
        torch.cuda.synchronize()
    assert k4.launches == sum(k in lm.SELF_ATTN_KINDS
                              for k in lm.layer_kinds(cfg))
    assert bool(torch.isfinite(logits).all())
    assert (real.flops, real.bytes) == (meta.flops, meta.bytes)
    assert real.flops > 0


def test_train_meta_trace_counts_the_card_step(dev):
    cfg = get_config("granite_moe_1b_a400m", smoke=True)
    step = make_train_step(cfg, lr=1e-3, microbatches=2)
    shape = (8, 32)
    mbatch = {k: torch.zeros(shape, dtype=torch.int64, device="meta")
              for k in ("tokens", "labels")}
    mstate = init_train_state(cfg, device="meta")
    with CostCounter("meta") as meta:
        step(mstate, mbatch)
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    batch = {k: torch.as_tensor(v).long().to(dev)
             for k, v in build_batches(cfg, 1, *shape)[0].items()}
    torch.cuda.synchronize()
    with CostCounter("cuda") as real:
        _, metrics = step(state, batch)
        loss = float(metrics["loss"])
    assert np.isfinite(loss)
    assert (real.flops, real.bytes) == (meta.flops, meta.bytes)
    assert real.flops > 0
