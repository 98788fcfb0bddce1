"""``lm_loss`` and its gradients on the port against
``jax.value_and_grad(repro.models.lm.lm_loss)``, family by family at
``SMOKE`` size in float32 (gemma3, the recurrent, cross-attention
and encoder-decoder families, and rematerialisation, in
``tests/test_torch_train_grads_more.py``).

The reference's parameters are carried across in the trainer's layout
(``params_from_jax(..., masters=True)``); its gradients are split the
same way.  Tolerances: the loss within 1e-4; each gradient leaf within
1e-4 of the reference's relative to the leaf's own largest reference
entry, plus 1e-7 (about float32 rounding at these gradients' scale, so a
leaf whose reference is all zeros must be zero too; every other SMOKE
leaf's largest entry is above 3e-3, so a port leaf of zeros or of the
wrong sign fails).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import build_batches  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import _split, params_from_jax  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = 1e-4
#: absolute floor of a gradient leaf's tolerance
FLOOR = 1e-7
ARCHS = ["granite_moe_1b_a400m", "mixtral_8x22b", "granite_3_8b",
         "stablelm_12b", "glm4_9b"]


def port_batch(batch):
    """A numpy batch as the port's tensors: token ids int64."""
    return {k: torch.from_numpy(v).long() if v.dtype.kind in "iu"
            else torch.from_numpy(v) for k, v in batch.items()}


def loss_and_grads_pair(arch, B=2, seq=24, **changes):
    """((reference loss, gradient leaves), (port loss, gradient leaves)),
    leaves in the port's order, for ``arch``'s SMOKE config in float32."""
    jcfg = jax_config(arch, smoke=True).replace(dtype=jnp.float32, **changes)
    tcfg = get_config(arch, smoke=True).replace(dtype=torch.float32,
                                                **changes)
    jparams = jlm.init_params(jax.random.key(0), jcfg)
    batch = build_batches(tcfg, 1, B, seq)[0]
    jl, jg = jax.value_and_grad(jlm.lm_loss)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    want = tree_leaves(_split(jax.tree.map(np.asarray, jg), tcfg,
                              torch.device("cpu"), lambda _: torch.float32))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu", masters=True)
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    tl = lm.lm_loss(tparams, port_batch(batch), tcfg)
    got = torch.autograd.grad(tl, leaves, allow_unused=True)
    got = [torch.zeros_like(t) if g is None else g
           for t, g in zip(leaves, got)]
    return (float(jl), want), (tl.item(), got)


def assert_grads_close(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        scale = float(w.abs().max())
        err = float((g.detach() - w).abs().max())
        assert err <= TOL * scale + FLOOR, (i, tuple(w.shape), err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_jax(arch):
    (jl, want), (tl, got) = loss_and_grads_pair(arch)
    assert np.isfinite(tl) and abs(tl - jl) <= TOL
    assert any(float(w.abs().max()) > 0 for w in want)
    assert_grads_close(got, want)


def test_loss_masks_negative_labels_and_pads_chunks(monkeypatch):
    """Labels of -1 count nothing; a sequence that is not a multiple of
    ``LOSS_CHUNK`` is padded with masked positions, as in the
    reference."""
    monkeypatch.setattr(lm, "LOSS_CHUNK", 10)
    monkeypatch.setattr(jlm, "LOSS_CHUNK", 10)
    jcfg = jax_config("granite_3_8b", smoke=True).replace(dtype=jnp.float32)
    tcfg = get_config("granite_3_8b", smoke=True).replace(
        dtype=torch.float32)
    jparams = jlm.init_params(jax.random.key(1), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu", masters=True)
    batch = build_batches(tcfg, 1, 2, 24, seed=4)[0]
    batch["labels"][:, ::3] = -1
    want = float(jlm.lm_loss(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg))
    got = float(lm.lm_loss(tparams, port_batch(batch), tcfg))
    assert abs(got - want) <= TOL
    full = dict(batch, labels=np.full_like(batch["labels"], -1))
    assert float(lm.lm_loss(tparams, port_batch(full), tcfg)) == 0.0
