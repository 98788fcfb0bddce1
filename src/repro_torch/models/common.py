"""Model configuration and parameter initialization of the LM serve path.

The counterpart of ``repro/models/common.py``: the same :class:`ModelConfig`
fields, with torch dtypes.  The reference's logical-axis sharding rules
(``logical``, ``set_sharding_rules``) have no counterpart yet: they belong
with the multi-device port (ROADMAP Queue 1 items 9 and 12).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

__all__ = ["ModelConfig", "dense_init", "UNPORTED"]

#: Where each family that the port does not serve yet stands in ROADMAP.md.
UNPORTED = "ROADMAP.md Queue 1 item 12 (LM substrate: moe, ssm/rwkv, " \
    "hybrid, vlm/audio)"


@dataclass(frozen=True)
class ModelConfig:
    """The reference's fields that the dense serve path reads; the fields
    of the other families (MoE, SSM, hybrid, VLM, audio) and of training
    come with their slices."""
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 512
    vocab_size: int = 256
    head_dim: Optional[int] = None
    # attention pattern
    sliding_window: Optional[int] = None   # SWA on all attention layers
    local_global_ratio: int = 0            # N local layers per global
    local_window: int = 1024
    # misc
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    act: str = "swiglu"  # swiglu | gelu
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    attn_chunk: int = 1024

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Total parameter count N, counted from the shapes of
        :func:`repro_torch.models.lm.init_params` on the meta device (no
        memory is allocated)."""
        from .lm import init_params  # lazy; avoids a cycle
        params = init_params(self, device="meta")
        return sum(math.prod(t.shape) for t in _leaves(params))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


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
