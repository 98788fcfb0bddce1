"""The port's per-chip FLOP count of a train step against the reference's
(``repro.launch.hlo_cost.analyze`` of the compiled HLO) on one chip, for
all ten families at SMOKE size: B=4, S=32, 2 microbatches, remat on.

Stated tolerance: within 3 %.  Each difference is named and held exact:

- every family, +2*B*S*d*V: the loss chunk's unembedding product, which
  ``torch.utils.checkpoint`` recomputes in the backward
  (``models/lm.py:lm_loss``, one chunk of ``LOSS_CHUNK`` positions a
  microbatch), where XLA merges the recomputation with the forward's
  product (the reference's ``jax.checkpoint(prevent_cse=False)``);
- rwkv6, the wkv intra-chunk score ``A[t,s] = sum_c r_tc k_sc dec_tsc``:
  a dot_general of 2*Bm*H*Q*Q*hd in the reference, 4 times a chunk
  (forward, recomputation, two gradients), an elementwise product summed
  over c in the port (no matmul);
- rwkv6 and zamba2, 3 products of the state size a layer and microbatch
  (2*Bm*H*Q*hd*hd, 2*Bm*Q*H*N*P): the first chunk's gradient of the zero
  initial state and the last chunk's two state-update gradients, which
  flow nowhere -- autograd prunes them, XLA's scan body computes them in
  every chunk;
- zamba2, 3 products of 2*Bm*Q*H*N a chunk: gradients of the SSD's
  broadcast products (scores x decay, dt x x), which XLA takes as
  dot_generals (a product and a reduction over one dim) and autograd as a
  product and a sum.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch.hlo_cost import analyze as jax_analyze  # noqa: E402
from repro.train import init_train_state as jax_state  # noqa: E402
from repro.train import make_train_step as jax_step  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch.hlo_cost import analyze  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402

B, S, MB = 4, 32, 2
TOL = 0.03


def _expected_difference(cfg) -> int:
    """Port minus reference FLOPs, by the named operations above."""
    Bm = B // MB
    diff = 2 * B * S * cfg.d_model * cfg.vocab_size
    if cfg.family == "ssm":  # rwkv6
        hd = cfg.ssm_head_dim
        H, Q = cfg.d_model // hd, min(cfg.rwkv_chunk, S)
        L, nc = cfg.num_layers, S // Q
        diff -= 4 * MB * L * nc * 2 * Bm * H * Q * Q * hd
        diff -= 3 * MB * L * 2 * Bm * H * Q * hd * hd
    if cfg.family == "hybrid":  # zamba2: every layer of the plan is Mamba2
        H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
        Q = min(cfg.ssm_chunk, S)
        L, nc = cfg.num_layers, S // Q
        diff -= 3 * MB * L * nc * 2 * Bm * Q * H * N
        diff -= 3 * MB * L * 2 * Bm * Q * H * N * P
    return diff


def check_train_step_flops(arch):
    """The port's FLOPs of one SMOKE train step against the reference's,
    by the named differences (also run by
    ``tests/test_torch_cost_train_more.py`` on the other half of the
    architectures, so the two halves run beside each other)."""
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    M = {"vlm": cfg.num_image_tokens,
         "audio": cfg.encoder_seq}.get(cfg.family, 0)
    jbatch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
              "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    batch = {k: torch.empty((B, S), dtype=torch.int64, device="meta")
             for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        jbatch["memory"] = jax.ShapeDtypeStruct((B, M, cfg.d_model),
                                                jcfg.dtype)
        batch["memory"] = torch.empty((B, M, cfg.d_model), dtype=cfg.dtype,
                                      device="meta")
    if cfg.family == "audio":
        jbatch["frames"] = jax.ShapeDtypeStruct((B, M, cfg.d_model),
                                                jnp.float32)
        batch["frames"] = torch.empty((B, M, cfg.d_model), device="meta")
    jstate = jax.eval_shape(lambda k: jax_state(k, jcfg), jax.random.key(0))
    text = jax.jit(jax_step(jcfg, lr=1e-4, microbatches=MB)).lower(
        jstate, jbatch).compile().as_text()
    want = jax_analyze(text)["flops"]
    res, (_, metrics) = analyze(make_train_step(cfg, lr=1e-4,
                                                microbatches=MB),
                                init_train_state(cfg, device="meta"), batch)
    assert set(metrics) >= {"loss", "grad_norm", "lr"}
    assert res["flops"] - want == _expected_difference(cfg)
    assert abs(res["flops"] / want - 1) < TOL


@pytest.mark.parametrize("arch", ARCHS[:5])
def test_train_step_flops_match_reference(arch):
    check_train_step_flops(arch)
