"""granite-3-8b [dense]: 40L d_model=4096 32H (GQA kv=8) d_ff=12800,
vocab=49155.  [hf:ibm-granite/granite-3.0-8b-base family]"""
from ..models.common import ModelConfig

FULL = ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    rope_theta=1e4,
)

SMOKE = FULL.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=128,
)
