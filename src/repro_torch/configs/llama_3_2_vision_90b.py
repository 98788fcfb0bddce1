"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8) d_ff=28672,
vocab=128256; cross-attention image layers every 5th layer; vision frontend
is a STUB (input_specs provides precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-90B-Vision family]"""
from ..models.common import ModelConfig

FULL = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    num_image_tokens=1024,
    rope_theta=5e5,
    tie_embeddings=False,
)

SMOKE = FULL.replace(
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=128, cross_attn_every=2, num_image_tokens=8,
)
