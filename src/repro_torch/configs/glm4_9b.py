"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696,
vocab=151552, RoPE.  [hf:THUDM/glm-4-9b]"""
from ..models.common import ModelConfig

FULL = ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    rope_theta=1e4,
)

SMOKE = FULL.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, d_ff=128,
    vocab_size=128,
)
