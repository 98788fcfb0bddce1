"""The port's banded sliding-window prefill (``_flash_banded``) and
gemma3-27b, against the reference package on the CPU.

``_flash_banded`` is held against the reference's within 1e-5 (float32;
both accumulate the same products in the same visiting order), and
against the port's unbanded chunk loop (``_flash_chunks``) on the same
q, k, v.  gemma3's ``SMOKE`` runs with ``attn_chunk=4`` and S = 32, so
its local layers (window 8) take the banded path; at the default chunk
of 1,024 they never would.  Forward, decode and greedy tokens are held
against the reference within 1e-4 in float32, with the reference's
parameters carried across (``models.convert.params_from_jax``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.layers import unembed as jax_unembed  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.layers import unembed  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

TOL = 1e-4       # whole models, float32
CORE_TOL = 1e-5  # the attention core alone, float32
ARCH, CHUNK, S = "gemma3_27b", 4, 32
MAX_SEQ = 40

# (S, window, chunk): windows a multiple of the chunk, not a multiple, and
# under the chunk; every case spans more chunks than its band
CASES = [(32, 8, 4), (64, 16, 8), (40, 8, 8), (48, 10, 4), (48, 9, 4),
         (32, 3, 4), (36, 5, 4)]


def _covers(window, chunk):
    """Whether ``window // chunk + 1`` chunks hold every key of a window:
    the first query of a chunk reaches ``window - 1`` positions back."""
    return window // chunk >= -(-(window - 1) // chunk)


def _qkv(S, window, B=2, H=4, hd=16):
    rng = np.random.default_rng(S * 31 + window)
    return [rng.normal(size=(B, S, H, hd)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("S,window,chunk", CASES)
def test_flash_banded_matches_reference(S, window, chunk):
    assert S % chunk == 0 and S // chunk > window // chunk + 1
    q, k, v = _qkv(S, window)
    pos = np.arange(S, dtype=np.int32)
    want = np.asarray(jattn._flash_banded(
        *map(jnp.asarray, (q, k, v, pos)), window=window, chunk=chunk))
    tq, tk, tv, tp = map(torch.from_numpy, (q, k, v, pos))
    got = tattn._flash_banded(tq, tk, tv, tp, window=window, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CORE_TOL)
    # the public dispatch takes the banded path under this condition
    via = tattn._flash(tq, tk, tv, tp, tp, causal=True, window=window,
                       chunk=chunk)
    assert torch.equal(via, got)
    unbanded = tattn._flash_chunks(tq, tk, tv, tp, tp, causal=True,
                                   window=window, chunk=chunk).numpy()
    if _covers(window, chunk):
        np.testing.assert_allclose(got.numpy(), unbanded, rtol=0,
                                   atol=CORE_TOL)
    else:
        # the reference's band of window // chunk + 1 chunks misses the
        # oldest keys of a window that is not a multiple of the chunk
        # (ROADMAP.md Queue 3); the port copies the reference
        assert np.abs(got.numpy() - unbanded).max() > 1e-3


@pytest.mark.parametrize("S,window,chunk", CASES[:3])
def test_flash_banded_gradients_match_reference(S, window, chunk):
    q, k, v = _qkv(S, window)
    pos = np.arange(S, dtype=np.int32)
    w = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jattn._flash_banded(q, k, v, jnp.asarray(pos),
                                           window=window, chunk=chunk) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tattn._flash_banded(*ts, torch.from_numpy(pos), window=window,
                              chunk=chunk)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=0,
                                   atol=CORE_TOL)


@functools.lru_cache(maxsize=None)
def _pair():
    jcfg = jax_config(ARCH, smoke=True).replace(dtype=jnp.float32,
                                                attn_chunk=CHUNK)
    tcfg = get_config(ARCH, smoke=True).replace(dtype=torch.float32,
                                                attn_chunk=CHUNK)
    jparams = jlm.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(cfg, B=2, seq=S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, seq)).astype(np.int32)


def test_gemma3_smoke_plan_and_window():
    _, _, tcfg, _ = _pair()
    assert lm.stage_plan(tcfg) == [(("attn_local",) * 2 + ("attn_global",),
                                    2)]
    assert tcfg.local_window == 8 and S // CHUNK > 8 // CHUNK + 1


def test_gemma3_forward_matches_jax_through_the_banded_path(monkeypatch):
    jcfg, jparams, tcfg, tparams = _pair()
    toks = _tokens(tcfg)
    x, _ = jlm.forward_hidden(jparams, jnp.asarray(toks), jcfg)
    want = np.asarray(jax_unembed(jparams["embed"], x, jcfg))
    calls = []
    real = tattn._flash_banded

    def count(*args, **kw):
        calls.append(kw["window"])
        return real(*args, **kw)

    monkeypatch.setattr(tattn, "_flash_banded", count)
    h, _ = lm.forward_hidden(tparams, torch.from_numpy(toks).long(), tcfg)
    got = unembed(tparams["embed"], h, tcfg).numpy()
    # every local layer takes the banded path, no global one does
    assert calls == [8] * lm.layer_kinds(tcfg).count("attn_local") == [8] * 4
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _decode_port(tcfg, tparams, toks):
    cache = lm.init_cache(tcfg, toks.shape[0], MAX_SEQ, device="cpu")
    tt = torch.from_numpy(toks).long()
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = lm.decode_step(tparams, cache, tt[:, t:t + 1], tcfg)
        outs.append(lg.numpy())
    return np.concatenate(outs, axis=1)


def test_gemma3_decode_matches_jax_and_the_banded_forward():
    jcfg, jparams, tcfg, tparams = _pair()
    toks = _tokens(tcfg, seed=1)
    step = jax.jit(functools.partial(jlm.decode_step, cfg=jcfg))
    cache = jlm.init_cache(jcfg, toks.shape[0], MAX_SEQ)
    want = []
    for t in range(toks.shape[1]):
        lg, cache = step(jparams, cache, jnp.asarray(toks[:, t:t + 1]))
        want.append(np.asarray(lg))
    got = _decode_port(tcfg, tparams, toks)
    np.testing.assert_allclose(got, np.concatenate(want, axis=1), rtol=0,
                               atol=TOL)
    # the ring caches of the local layers (window 8) against the banded
    # forward over the same tokens: every position
    h, _ = lm.forward_hidden(tparams, torch.from_numpy(toks).long(), tcfg)
    np.testing.assert_allclose(unembed(tparams["embed"], h, tcfg).numpy(),
                               got, rtol=0, atol=TOL)


def test_gemma3_generate_greedy_matches_jax():
    jcfg, jparams, tcfg, tparams = _pair()
    prompts = _tokens(tcfg, seq=12, seed=3)
    want = JaxEngine(jcfg, jparams, max_seq=MAX_SEQ).generate(prompts, 12)
    got = ServeEngine(tcfg, tparams, max_seq=MAX_SEQ,
                      device="cpu").generate(prompts, 12)
    np.testing.assert_array_equal(got, want)


def test_gemma3_full_config_is_the_reference_s():
    full = get_config("gemma3-27b")
    ref = jax_config("gemma3-27b")
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "local_global_ratio", "local_window",
              "head_dim", "rope_theta", "act", "attn_chunk"):
        assert getattr(full, f) == getattr(ref, f), f
    assert full.param_count() == 19_840_778_496
    kinds = lm.layer_kinds(full)
    assert len(kinds) == 62 and kinds.count("attn_global") == 10
