"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504,
vocab=262144, 5:1 local:global attention (window 1024), 128k context.
[hf:google/gemma-3-27b family]"""
from ..models.common import ModelConfig

FULL = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    local_global_ratio=5,
    local_window=1024,
    head_dim=128,
    rope_theta=1e6,
    act="gelu",
)

SMOKE = FULL.replace(
    num_layers=6, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=256, local_global_ratio=2, local_window=8, head_dim=16,
)
