"""The port's per-chip FLOP count (``repro_torch.launch.hlo_cost``) against
the reference's (``repro.launch.hlo_cost.analyze`` of the compiled HLO) on
one chip, for all ten families at SMOKE size: the decode step (B=2, a
64-position cache) and the prefill (B=2, S=64).

Both count matmul FLOPs only (2*M*N*K).  The port's side runs on meta
tensors (K4 reports its reckoned 4*B*H*C*hd, the FLOPs of the reference's
two einsums).  They are equal, but for the rwkv6 prefill: the reference
writes the intra-chunk score of the wkv scan, ``A[t,s] = sum_c r_tc k_sc
dec_tsc``, as a three-operand einsum that XLA lowers to a dot_general of
2*B*H*Q*Q*hd FLOPs a chunk, the port as an elementwise product summed over
c (``models/rwkv.py:time_mix_forward``), which no matmul counts.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch.hlo_cost import analyze as jax_analyze  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import prefill_step as jax_prefill  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch.hlo_cost import analyze  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import prefill_step  # noqa: E402

B, C, S = 2, 64, 64


def _memory_len(cfg):
    return {"vlm": cfg.num_image_tokens,
            "audio": cfg.encoder_seq}.get(cfg.family, 0)


def _jax_flops(fn, *args):
    text = jax.jit(fn).lower(*args).compile().as_text()
    return jax_analyze(text)["flops"]


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_flops_equal_reference(arch):
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    M = _memory_len(cfg)
    jp = jax.eval_shape(lambda k: jlm.init_params(k, jcfg), jax.random.key(0))
    jcache = jax.eval_shape(lambda: jlm.init_cache(jcfg, B, C, M))
    want = _jax_flops(lambda p, c, t: jlm.decode_step(p, c, t, jcfg), jp,
                      jcache, jax.ShapeDtypeStruct((B, 1), jnp.int32))
    res, (logits, _) = analyze(
        lm.decode_step, lm.init_params(cfg, device="meta"),
        lm.init_cache(cfg, B, C, M, device="meta"),
        _meta((B, 1), torch.int64), cfg)
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert res["flops"] == want


def _rwkv_intra_flops(cfg, batch, seq):
    """2*B*H*Q*Q*hd FLOPs a chunk and layer: the reference's dot_general
    of the wkv intra-chunk score, an elementwise product in the port."""
    hd = cfg.ssm_head_dim
    H, Q = cfg.d_model // hd, min(cfg.rwkv_chunk, seq)
    return cfg.num_layers * (seq // Q) * 2 * batch * H * Q * Q * hd


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_flops_equal_reference(arch):
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    M = _memory_len(cfg)
    jp = jax.eval_shape(lambda k: jlm.init_params(k, jcfg), jax.random.key(0))
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    params = lm.init_params(cfg, device="meta")
    ttok = _meta((B, S), torch.int64)
    if cfg.family == "audio":
        fr = jax.ShapeDtypeStruct((B, M, jcfg.d_model), jnp.float32)
        want = _jax_flops(lambda p, t, f: jax_prefill(
            p, t, jcfg, jlm.encode_frames(p, f, jcfg)), jp, tok, fr)
        res, _ = analyze(lambda: prefill_step(
            params, ttok, cfg,
            lm.encode_frames(params, _meta((B, M, cfg.d_model)), cfg)))
    elif cfg.family == "vlm":
        mem = jax.ShapeDtypeStruct((B, M, jcfg.d_model), jcfg.dtype)
        want = _jax_flops(lambda p, t, m: jax_prefill(p, t, jcfg, m), jp,
                          tok, mem)
        res, _ = analyze(prefill_step, params, ttok, cfg,
                         _meta((B, M, cfg.d_model), cfg.dtype))
    else:
        want = _jax_flops(lambda p, t: jax_prefill(p, t, jcfg), jp, tok)
        res, _ = analyze(prefill_step, params, ttok, cfg)
    expect = -_rwkv_intra_flops(cfg, B, S) if arch == "rwkv6_3b" else 0
    assert res["flops"] - want == expect
    assert res["flops"] > 0
