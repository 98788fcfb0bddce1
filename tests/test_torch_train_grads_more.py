"""``lm_loss`` and its gradients against the reference's for the families
that ``tests/test_torch_train_grads.py`` leaves (gemma3 through its banded
prefill, zamba2, RWKV6, the cross-attention VLM, whisper), and
rematerialisation: remat on, off and ``remat_policy="dots"`` give the
same numbers, and the forward checkpoints one super-block at a time only
while gradients are taken.  Tolerances as there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_train_grads import (TOL, assert_grads_close,  # noqa: E402
                                    loss_and_grads_pair, port_batch)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import build_batches  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCHS = ["zamba2_1_2b", "rwkv6_3b", "llama_3_2_vision_90b",
         "whisper_tiny"]


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_jax(arch):
    (jl, want), (tl, got) = loss_and_grads_pair(arch)
    assert np.isfinite(tl) and abs(tl - jl) <= TOL
    assert_grads_close(got, want)


def test_gemma3_loss_and_gradients_through_the_banded_path():
    """S = 32 in chunks of 4: the local layers (window 8) take
    ``_flash_banded`` in the forward and its backward."""
    (jl, want), (tl, got) = loss_and_grads_pair("gemma3_27b", seq=32,
                                                attn_chunk=4)
    assert abs(tl - jl) <= TOL
    assert_grads_close(got, want)


def _loss_grads(arch, **changes):
    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32,
                                               **changes)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", masters=True)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    batch = port_batch(build_batches(cfg, 1, 2, 16, seed=2)[0])
    loss = lm.lm_loss(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [g for g in grads if g is not None]


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "zamba2_1_2b",
                                  "rwkv6_3b", "whisper_tiny"])
def test_remat_policies_give_the_same_numbers(arch, monkeypatch):
    from torch.utils import checkpoint as ckpt
    calls = []
    real = ckpt.checkpoint

    def count(fn, *args, **kw):
        calls.append(fn.__name__)
        return real(fn, *args, **kw)

    monkeypatch.setattr(ckpt, "checkpoint", count)
    off = _loss_grads(arch, remat=False)
    assert calls == []
    full = _loss_grads(arch)
    cfg = get_config(arch, smoke=True)
    blocks = sum(reps for _, reps in lm.stage_plan(cfg)) \
        + cfg.encoder_layers
    assert calls.count("_apply_block") == blocks
    assert calls.count("_chunk_loss") == 1
    dots = _loss_grads(arch, remat_policy="dots")
    for other in (full, dots):
        assert torch.equal(other[0], off[0])
        assert len(other[1]) == len(off[1])
        for a, b in zip(other[1], off[1]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_no_remat_without_gradients(monkeypatch):
    from torch.utils import checkpoint as ckpt
    monkeypatch.setattr(ckpt, "checkpoint", None)  # would fail if called
    cfg = get_config("granite_3_8b", smoke=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.long)
    lm.forward_hidden(params, toks, cfg)  # serve layout: nothing needs grad
    with torch.no_grad():
        for t in tree_leaves(params):
            t.requires_grad_(True)
        lm.forward_hidden(params, toks, cfg)
