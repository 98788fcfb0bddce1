"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960,
vocab=65536; Finch data-dependent decay.  [arXiv:2404.05892]"""
from ..models.common import ModelConfig

FULL = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,       # d_model / 64 wkv heads
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    ssm_head_dim=64,
    rwkv_chunk=32,
)

SMOKE = FULL.replace(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=128, ssm_head_dim=16, rwkv_chunk=8,
)
