"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (GQA kv=32) d_ff=8192,
ssm_state=64; Mamba2 backbone + weight-shared attention block applied every
6 layers.  Shared attn uses a 4096 sliding window so the 500k decode cell is
feasible (DESIGN.md Sec. 6, adaptation #4).  [arXiv:2411.15242]"""
from ..models.common import ModelConfig

FULL = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
    sliding_window=4096,
    rope_theta=1e4,
)

SMOKE = FULL.replace(
    num_layers=7, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=128, ssm_state=16, ssm_head_dim=16, attn_every=3,
    sliding_window=16, ssm_chunk=8,
)
