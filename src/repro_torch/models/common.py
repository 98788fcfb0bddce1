"""Model configuration and parameter initialization of the LM.

The counterpart of ``repro/models/common.py``: the same :class:`ModelConfig`
fields and defaults, with torch dtypes.  The reference's logical-axis
sharding rules (``logical``, ``set_sharding_rules``), its expert-parallel
switch (``moe_expert_parallel``), ``train_microbatches`` (read only by its
dryrun) and ``scan_layers`` have no counterpart yet: they belong with
dryrun and sharding (:data:`UNPORTED`).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

__all__ = ["ModelConfig", "dense_init", "UNPORTED"]

#: Where what the port does not have yet stands in ROADMAP.md.
UNPORTED = "ROADMAP.md Queue 1 item 12.5 (dryrun, sharding)"


@dataclass(frozen=True)
class ModelConfig:
    """The reference's fields, letter for letter
    (``repro/models/common.py:18-76``), but for the sharding ones."""
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 512
    vocab_size: int = 256
    head_dim: Optional[int] = None
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # attention pattern
    sliding_window: Optional[int] = None   # SWA on all attention layers
    local_global_ratio: int = 0            # N local layers per global
    local_window: int = 1024
    # ssm / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    attn_every: int = 0                    # zamba2: shared attn every k layers
    # vlm
    cross_attn_every: int = 0
    num_image_tokens: int = 0
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0
    # misc
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    act: str = "swiglu"  # swiglu | gelu
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    remat_policy: str = "full"  # full | dots (save unbatched matmul outputs)
    rwkv_chunk: int = 64
    ssm_chunk: int = 128
    attn_chunk: int = 1024

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Total parameter count N, counted from the shapes of
        :func:`repro_torch.models.lm.init_params` on the meta device (no
        memory is allocated)."""
        from ..tree import tree_leaves
        from .lm import init_params  # lazy; avoids a cycle
        params = init_params(self, device="meta")
        return sum(math.prod(t.shape) for t in tree_leaves(params))


def dense_init(shape, in_axis: int = 0, dtype=torch.float32,
               generator: Optional[torch.Generator] = None,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: a standard normal truncated to [-2, 2],
    scaled by ``fan_in ** -0.5``, drawn from ``generator`` on ``device`` in
    float32 and cast to ``dtype``.  The numbers differ from the reference's
    ``jax.random.truncated_normal`` for the same seed; tests carry the
    reference's weights across instead (``models.convert``)."""
    fan_in = shape[in_axis] if len(shape) else 1
    scale = 1.0 / max(fan_in, 1) ** 0.5
    t = torch.empty(shape, dtype=torch.float32, device=device)
    # inverse-CDF sampling, as torch.nn.init.trunc_normal_ does
    lo, hi = (math.erf(-2.0 / math.sqrt(2.0)) + 1) / 2, \
        (math.erf(2.0 / math.sqrt(2.0)) + 1) / 2
    t.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    t.erfinv_().mul_(math.sqrt(2.0) * scale)
    t.clamp_(-2.0 * scale, 2.0 * scale)
    return t.to(dtype)
