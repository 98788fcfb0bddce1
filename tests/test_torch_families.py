"""The port's other decode families (moe, ssm/RWKV6, hybrid/zamba2,
vlm, audio/whisper) against the reference package at ``SMOKE`` size.

The reference's parameters are carried across with
``models.convert.params_from_jax``.  Tolerances as in
``tests/test_torch_serve.py``: within 1e-4 absolute in float32 configs
(both sides compute the same float32 products, in another order); in the
configs' own bfloat16, the reference test's contract (allclose atol 0.75 /
rtol 0.1, argmax agreement above 0.9).  On CPU tensors K4's wrapper runs
its plain version; the kernel is held against it on the card
(``tests/test_torch_cuda_families.py``, ``chip_smoke.py``).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.layers import unembed as jax_unembed  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm, moe, rwkv, ssm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.layers import unembed  # noqa: E402
from repro_torch.serve import ServeEngine, prefill_step  # noqa: E402

FAMILIES = ["granite_moe_1b_a400m", "mixtral_8x22b", "rwkv6_3b",
            "zamba2_1_2b", "llama_3_2_vision_90b", "whisper_tiny"]
TOL = 1e-4
STEPS = 12
MAX_SEQ = 8  # < STEPS: the self-attention rings wrap


def _as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _pair(arch, f32=True):
    """(jax cfg, jax params, port cfg, port params on the CPU)."""
    jcfg, tcfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    if f32:
        jcfg, tcfg = jcfg.replace(dtype=jnp.float32), \
            tcfg.replace(dtype=torch.float32)
    jparams = jlm.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(_as_numpy(jparams), tcfg, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(cfg, B=2, S=STEPS, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _memory_len(cfg):
    return serve_cli.memory_len(cfg)


@functools.lru_cache(maxsize=None)
def _memory(arch, f32=True, B=2):
    """(jax memory, port memory): image embeddings (vlm) or the encoder's
    output over seeded frames (audio); None for the other families."""
    jcfg, jparams, tcfg, tparams = _pair(arch, f32)
    M = _memory_len(jcfg)
    if not M:
        return None, None
    x = np.random.default_rng(9).normal(
        size=(B, M, jcfg.d_model)).astype(np.float32)
    if jcfg.family == "vlm":
        return jnp.asarray(x).astype(jcfg.dtype), \
            torch.from_numpy(x).to(tcfg.dtype)
    return (jlm.encode_frames(jparams, jnp.asarray(x), jcfg),
            lm.encode_frames(tparams, torch.from_numpy(x), tcfg))


@functools.lru_cache(maxsize=None)
def _jax_step(arch, f32=True):
    """The reference's jitted decode step, compiled once a config and
    shared by the decode and generate tests (both at B=2, ``MAX_SEQ``)."""
    jcfg = _pair(arch, f32)[0]
    return jax.jit(functools.partial(jlm.decode_step, cfg=jcfg))


@functools.lru_cache(maxsize=None)
def _decode_jax(arch, f32=True, seed=0):
    jcfg, jparams, _, _ = _pair(arch, f32)
    toks = _tokens(jcfg, seed=seed)
    cache = jlm.init_cache(jcfg, toks.shape[0], MAX_SEQ, _memory_len(jcfg))
    step = _jax_step(arch, f32)
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = step(jparams, cache, jnp.asarray(toks[:, t:t + 1]))
        outs.append(np.asarray(lg, dtype=np.float32))
    return np.concatenate(outs, axis=1)


def _decode_port(tcfg, tparams, toks, max_seq=MAX_SEQ):
    cache = lm.init_cache(tcfg, toks.shape[0], max_seq, _memory_len(tcfg),
                          device="cpu")
    tt = torch.from_numpy(toks).long()
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = lm.decode_step(tparams, cache, tt[:, t:t + 1], tcfg)
        outs.append(lg.float().numpy())
    assert cache.length == toks.shape[1]
    return np.concatenate(outs, axis=1), cache


def _forward(arch, f32=True, seed=1):
    """(reference logits, port logits) of the forward over seeded tokens."""
    jcfg, jparams, tcfg, tparams = _pair(arch, f32)
    jmem, tmem = _memory(arch, f32)
    toks = _tokens(tcfg, seed=seed)
    x, _ = jlm.forward_hidden(jparams, jnp.asarray(toks), jcfg, jmem)
    want = np.asarray(jax_unembed(jparams["embed"], x, jcfg))
    h, _ = lm.forward_hidden(tparams, torch.from_numpy(toks).long(), tcfg,
                             tmem)
    return want, unembed(tparams["embed"], h, tcfg).numpy()


# ------------------------------------------------------------ whole models


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_matches_jax_f32(arch):
    _, _, tcfg, tparams = _pair(arch)
    got, cache = _decode_port(tcfg, tparams, _tokens(tcfg))
    assert got.shape == (2, STEPS, tcfg.vocab_size)
    np.testing.assert_allclose(got, _decode_jax(arch), rtol=0, atol=TOL)
    # the cross caches are never advanced, the self-attention ones are
    for kind, c in zip(lm.layer_kinds(tcfg), cache.layers):
        if kind == "cross":
            assert c.length == 0 and not c.k.any()
        elif kind == "dec_attn":
            assert c["cross"].length == 0 and c["self"].length == STEPS
        elif kind in lm.SELF_ATTN_KINDS:
            assert c.length == STEPS


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_jax_f32(arch):
    want, got = _forward(arch)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    _, _, tcfg, tparams = _pair(arch)
    _, tmem = _memory(arch)
    tt = torch.from_numpy(_tokens(tcfg, seed=1)).long()
    np.testing.assert_allclose(prefill_step(tparams, tt, tcfg, tmem).numpy(),
                               want[:, -1:], rtol=0, atol=TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_generate_greedy_matches_jax_f32(arch):
    jcfg, jparams, tcfg, tparams = _pair(arch)
    M = _memory_len(jcfg)
    prompts = _tokens(tcfg, S=5, seed=3)
    ref = JaxEngine(jcfg, jparams, max_seq=MAX_SEQ, memory_len=M)
    ref._decode = _jax_step(arch)  # the same jitted function, compiled once
    want = ref.generate(prompts, 8)
    eng = ServeEngine(tcfg, tparams, max_seq=MAX_SEQ, memory_len=M,
                      device="cpu")
    got = eng.generate(prompts, 8)
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)
    assert eng.stats["generated_tokens"] == 16


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_meets_reference_contract(arch):
    """bfloat16 forward and decode logits against the reference's; the
    leaves the reference reads in float32 stay float32."""
    _, _, tcfg, tparams = _pair(arch, f32=False)
    assert tcfg.dtype == torch.bfloat16
    assert tparams["embed"]["table"].dtype == torch.float32
    for kind, p in zip(lm.layer_kinds(tcfg), tparams["layers"]):
        p = lm._layer_params(tparams, kind, p)
        assert p["norm1"]["scale"].dtype == torch.float32
        if kind == "moe_attn":
            assert p["moe"]["router"].dtype == torch.float32
            assert p["moe"]["experts_up"].dtype == torch.bfloat16
        if kind == "ssm":
            assert {p["ssm"][k].dtype for k in ("A_log", "D", "dt_bias",
                                                "conv_w")} == {torch.float32}
            assert p["ssm"]["norm"]["scale"].dtype == torch.float32
            assert p["ssm"]["in_proj"].dtype == torch.bfloat16
        if kind == "rwkv":
            assert {p["tm"][k].dtype for k in ("w0", "u")} == {torch.float32}
            assert p["tm"]["ln_out"]["scale"].dtype == torch.float32
        if kind == "dec_attn":
            assert p["norm_x"]["scale"].dtype == torch.float32
    fwd_want, fwd_got = _forward(arch, f32=False, seed=2)
    dec_want = _decode_jax(arch, f32=False, seed=2)
    dec_got, _ = _decode_port(tcfg, tparams, _tokens(tcfg, seed=2))
    for got, want in ((fwd_got, fwd_want), (dec_got, dec_want)):
        np.testing.assert_allclose(got, want, atol=0.75, rtol=0.1)
        agree = np.mean(np.argmax(got, -1) == np.argmax(want, -1))
        assert agree > 0.9, agree


@pytest.mark.parametrize("arch", ["rwkv6_3b", "zamba2_1_2b"])
def test_decode_matches_forward_recurrent(arch):
    """``tests/test_serve_and_data.py``'s recurrent contract on the port:
    decode and the chunked forward agree in argmax above 0.9 (float32)."""
    cfg = get_config(arch, smoke=True).replace(dtype=torch.float32)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    toks = _tokens(cfg, seed=1)
    h, _ = lm.forward_hidden(params, torch.from_numpy(toks).long(), cfg)
    full = unembed(params["embed"], h, cfg).numpy()
    dec, _ = _decode_port(cfg, params, toks, max_seq=STEPS)
    agree = np.mean(np.argmax(dec, -1) == np.argmax(full, -1))
    assert agree > 0.9, f"decode/forward divergence: argmax agree {agree}"
    np.testing.assert_allclose(dec, full, rtol=0, atol=TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_self_attention_decodes_take_the_k4_core(arch, monkeypatch):
    """One call of K4's wrapper per self-attention layer and step (none for
    RWKV6); the cross decodes take the plain einsum."""
    _, _, tcfg, tparams = _pair(arch)
    calls = []
    real = tattn.flash_decode

    def count(*args):
        calls.append(args[1].shape)
        return real(*args)

    monkeypatch.setattr(tattn, "flash_decode", count)
    _decode_port(tcfg, tparams, _tokens(tcfg, S=3))
    kinds = lm.layer_kinds(tcfg)
    per_step = sum(k in lm.SELF_ATTN_KINDS for k in kinds)
    assert len(calls) == 3 * per_step
    assert (per_step == 0) == (tcfg.family == "ssm")


# ----------------------------------------------------------- module pairs


def _moe_reference_keep(jp, x, cfg):
    """The reference's ``keep`` mask, by its own formula (``moe.py``)."""
    B, S, _ = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = max(int(S * K / E * cfg.capacity_factor), 1)
    probs = jax.nn.softmax(x.astype(jnp.float32)
                           @ jp["router"].astype(jnp.float32), axis=-1)
    _, topk = jax.lax.top_k(probs, K)
    oh = jax.nn.one_hot(topk.reshape(B, S * K), E, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(oh, axis=1) - 1) * oh, axis=-1)
    return np.asarray(pos < C), np.asarray(topk)


@pytest.mark.parametrize("changes", [
    dict(),                                   # capacity 7 for 24 copies
    dict(capacity_factor=0.5, act="gelu"),    # capacity 3: drops
    dict(num_experts=8, experts_per_token=1),
], ids=["swiglu", "drops_gelu", "top1"])
def test_moe_ffn_matches_jax(changes):
    jcfg = jax_config("granite_moe_1b_a400m", smoke=True).replace(
        dtype=jnp.float32, **changes)
    tcfg = get_config("granite_moe_1b_a400m", smoke=True).replace(
        dtype=torch.float32, **changes)
    jp = jmoe.init_moe(jax.random.key(3), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(4).normal(
        size=(2, 12, jcfg.d_model)).astype(np.float32)
    jy, jaux = jax.jit(functools.partial(jmoe.moe_ffn, cfg=jcfg))(
        jp, jnp.asarray(x))
    ty, taux, keep = moe._moe_ffn(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)
    want_keep, _ = _moe_reference_keep(jp, jnp.asarray(x), jcfg)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if "capacity_factor" in changes:
        assert not want_keep.all()  # the case drops tokens


def test_top_k_breaks_ties_to_the_lower_index():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 4, size=(64, 16)).astype(np.float32)  # many ties
    jv, ji = jax.lax.top_k(jnp.asarray(x), 5)
    tv, ti = moe.top_k(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_bf16_router_choices_match_jax():
    """In a bfloat16 model every token picks the reference's experts: the
    router is read and multiplied in float32."""
    jcfg, jparams, tcfg, tparams = _pair("granite_moe_1b_a400m", f32=False)
    jcfg, tcfg = jcfg.replace(num_experts=4), tcfg.replace(num_experts=4)
    jp, tp = jparams["stages"][0]["p0"]["moe"], tparams["layers"][0]["moe"]
    jp = {k: v[0] for k, v in jp.items()}
    x = np.random.default_rng(6).normal(
        size=(16, 512, jcfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want_keep, want_topk = _moe_reference_keep(jp, xj, jcfg)
    probs = torch.softmax(xt.float() @ tp["router"].float(), dim=-1)
    _, topk = moe.top_k(probs, tcfg.experts_per_token)
    np.testing.assert_array_equal(topk.numpy(), want_topk)
    _, _, keep = moe._moe_ffn(tp, xt, tcfg)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    # a router cast to bfloat16 routes otherwise on some token
    _, bf_topk = moe.top_k(torch.softmax(
        (xt @ tp["router"].to(torch.bfloat16)).float(), dim=-1), 2)
    assert not np.array_equal(bf_topk.numpy(), want_topk)


def _tree(jp, cfg):
    """A reference sub-tree of arrays as the port's tensors, with the
    converter's dtypes (one unstacked layer)."""
    from repro_torch.models import convert
    return convert._convert(_as_numpy(jp), None, cfg, torch.device("cpu"))


@pytest.mark.parametrize("S", [12, 21])  # 21: a padded last chunk
def test_ssm_forward_and_decode_match_jax(S):
    jcfg = jax_config("zamba2_1_2b", smoke=True).replace(dtype=jnp.float32)
    tcfg = get_config("zamba2_1_2b", smoke=True).replace(dtype=torch.float32)
    jp = jssm.init_ssm(jax.random.key(7), jcfg)
    jp = dict(jp, A_log=jnp.linspace(-1.0, 1.0, jcfg.ssm_heads),
              dt_bias=jnp.linspace(-0.5, 0.5, jcfg.ssm_heads))
    tp = _tree(jp, tcfg)
    u = np.random.default_rng(8).normal(
        size=(2, S, jcfg.d_model)).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(jssm.ssm_forward, cfg=jcfg))(
        jp, jnp.asarray(u)))
    jdecode = jax.jit(functools.partial(jssm.ssm_decode, cfg=jcfg))
    got = ssm.ssm_forward(tp, torch.from_numpy(u), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    jc, tc = jssm.init_ssm_cache(jcfg, 2), ssm.init_ssm_cache(tcfg, 2)
    for t in range(S):
        jo, jc = jdecode(jp, jnp.asarray(u[:, t:t + 1]), jc)
        to, tc = ssm.ssm_decode(tp, torch.from_numpy(u[:, t:t + 1]), tc,
                                tcfg)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(to.numpy()[:, 0], want[:, t], rtol=0,
                                   atol=TOL)  # decode == forward
    assert tc.length == int(jc.length) == S
    np.testing.assert_allclose(tc.state.numpy(), np.asarray(jc.state),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(tc.conv.numpy(), np.asarray(jc.conv),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("S", [12, 19])  # 19: a padded last chunk
def test_time_mix_and_channel_mix_match_jax(S):
    jcfg = jax_config("rwkv6_3b", smoke=True).replace(dtype=jnp.float32)
    tcfg = get_config("rwkv6_3b", smoke=True).replace(dtype=torch.float32)
    jtm = jrwkv.init_time_mix(jax.random.key(10), jcfg)
    jtm = dict(jtm, u=jax.random.normal(jax.random.key(11), jtm["u"].shape),
               w0=jnp.linspace(-2.0, 1.0, jcfg.d_model))
    jcm = jrwkv.init_channel_mix(jax.random.key(12), jcfg)
    ttm, tcm = _tree(jtm, tcfg), _tree(jcm, tcfg)
    x = np.random.default_rng(13).normal(
        size=(2, S, jcfg.d_model)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    def jit(f):
        return jax.jit(functools.partial(f, cfg=jcfg))

    want_tm = np.asarray(jit(jrwkv.time_mix_forward)(jtm, xj))
    np.testing.assert_allclose(rwkv.time_mix_forward(ttm, xt, tcfg).numpy(),
                               want_tm, rtol=0, atol=TOL)
    want_cm = np.asarray(jit(jrwkv.channel_mix_forward)(jcm, xj))
    tm_decode, cm_decode = jit(jrwkv.time_mix_decode), \
        jit(jrwkv.channel_mix_decode)
    np.testing.assert_allclose(
        rwkv.channel_mix_forward(tcm, xt, tcfg).numpy(), want_cm, rtol=0,
        atol=TOL)
    jc, tc = jrwkv.init_rwkv_cache(jcfg, 2), rwkv.init_rwkv_cache(tcfg, 2)
    for t in range(S):
        jo, jc = tm_decode(jtm, xj[:, t:t + 1], jc)
        to, tc = rwkv.time_mix_decode(ttm, xt[:, t:t + 1], tc, tcfg)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(to.numpy()[:, 0], want_tm[:, t], rtol=0,
                                   atol=TOL)  # decode == forward
        jo, jc = cm_decode(jcm, xj[:, t:t + 1], jc)
        to, tc = rwkv.channel_mix_decode(tcm, xt[:, t:t + 1], tc, tcfg)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                                   atol=TOL)
    assert tc.length == int(jc.length) == S
    np.testing.assert_allclose(tc.state.numpy(), np.asarray(jc.state),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("M,dtype", [(8, "float32"), (37, "float32"),
                                     (37, "bfloat16")])
def test_cross_attention_matches_jax(M, dtype):
    """No mask and no RoPE over the chunked core (chunk 16: M=37 pads)."""
    jcfg = jax_config("llama_3_2_vision_90b", smoke=True).replace(
        dtype=jnp.float32, attn_chunk=16)
    tcfg = get_config("llama_3_2_vision_90b", smoke=True).replace(
        dtype=torch.float32, attn_chunk=16)
    jp = jattn.init_attention(jax.random.key(14), jcfg, cross=True)
    tp = _tree(jp, tcfg)
    rng = np.random.default_rng(15)
    x = rng.normal(size=(2, 5, jcfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(2, M, jcfg.d_model)).astype(np.float32)
    jmem = jnp.asarray(mem).astype(getattr(jnp, dtype))
    tmem = torch.from_numpy(mem).to(getattr(torch, dtype))
    want = np.asarray(jattn.cross_attention(jp, jnp.asarray(x), jmem, jcfg))
    got = tattn.cross_attention(tp, torch.from_numpy(x), tmem, tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_encode_frames_matches_jax():
    jcfg, jparams, tcfg, tparams = _pair("whisper_tiny")
    jmem, tmem = _memory("whisper_tiny")
    assert tmem.shape == (2, jcfg.encoder_seq, jcfg.d_model)
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), rtol=0,
                               atol=TOL)
    with pytest.raises(ValueError, match="encoder memory"):
        lm.forward_hidden(tparams, torch.zeros((1, 2), dtype=torch.long),
                          tcfg)


# ------------------------------------------------------ configs and params


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_and_param_count_match_jax(arch):
    """Every ported FULL config equals the reference's field by field (the
    reference's sharding fields aside), and counts its
    parameters alike (on the meta device)."""
    jcfg, tcfg = jax_config(arch), get_config(arch)
    for f in dataclasses.fields(tcfg):
        got, want = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if f.name in ("dtype", "param_dtype"):
            got, want = str(got).split(".")[-1], np.dtype(want).name
        assert got == want, f.name
    assert (tcfg.d_inner, tcfg.ssm_heads) == (jcfg.d_inner, jcfg.ssm_heads)
    assert tcfg.param_count() == jcfg.param_count()
    assert get_config(arch, smoke=True) == get_config(arch, smoke=True)


def test_port_serves_nine_of_ten_architectures():
    """The nine architectures served before gemma3-27b still are, with
    their plans; :func:`test_port_serves_ten_of_ten_architectures` holds
    the whole registry."""
    nine = [a for a in JAX_ARCHS if a != "gemma3_27b"]
    assert set(nine) < set(ARCHS)
    for arch in nine:
        assert get_config(arch, smoke=True).name == \
            jax_config(arch, smoke=True).name
    z = get_config("zamba2_1_2b")
    assert lm.stage_plan(z) == [(("shared_attn",) + ("ssm",) * 6, 6),
                                (("ssm",), 2)]
    v = get_config("llama-3.2-vision-90b")
    assert lm.stage_plan(v) == [(("attn",) * 4 + ("cross",), 20)]


def test_port_serves_ten_of_ten_architectures():
    assert ARCHS == JAX_ARCHS
    for alias in ("gemma3-27b", "zamba2-1.2b", "llama-3.2-vision-90b",
                  "granite-moe-1b-a400m", "whisper-tiny"):
        assert get_config(alias).name == jax_config(alias).name
    g = get_config("gemma3-27b")
    assert lm.stage_plan(g) == [(("attn_local",) * 5 + ("attn_global",), 10),
                                (("attn_local",), 2)]
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("gemma4-1t")


def test_zamba2_shared_block_is_stored_once():
    _, jparams, tcfg, tparams = _pair("zamba2_1_2b")
    kinds = lm.layer_kinds(tcfg)
    assert kinds.count("shared_attn") == 2 and len(kinds) == 9
    assert all(p == {} for k, p in zip(kinds, tparams["layers"])
               if k == "shared_attn")
    np.testing.assert_array_equal(
        tparams["shared"]["attn"]["wq"].numpy(),
        np.asarray(jparams["shared"]["attn"]["wq"]))
    n = sum(t.numel() for t in jax.tree.leaves(
        tparams, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert n == tcfg.param_count() == sum(
        a.size for a in jax.tree.leaves(jparams))


def test_launcher_defaults_to_rwkv6_on_cpu(capsys):
    serve_cli.main(["--smoke", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "3", "--gen", "4"])
    out = capsys.readouterr().out
    assert "arch=rwkv6-3b" in out and "generated (2, 4)" in out
    serve_cli.main(["--arch", "whisper-tiny", "--smoke", "--device", "cpu",
                    "--batch", "1", "--prompt-len", "2", "--gen", "2"])
    assert "arch=whisper-tiny" in capsys.readouterr().out
