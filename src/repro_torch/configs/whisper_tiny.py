"""whisper-tiny [audio]: 4L d_model=384 6H d_ff=1536 vocab=51865; enc-dec
with conv frontend STUB (input_specs provides precomputed frame embeddings,
1500 frames).  [arXiv:2212.04356]"""
from ..models.common import ModelConfig

FULL = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,           # decoder layers
    encoder_layers=4,
    encoder_seq=1500,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    act="gelu",
)

SMOKE = FULL.replace(
    num_layers=2, encoder_layers=2, encoder_seq=16, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=128,
)
