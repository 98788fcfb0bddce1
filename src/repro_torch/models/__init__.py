"""The LM serve path's models (every family but gemma3's banded prefill):
config, layers, attention with the K4 decode kernel, MoE, SSM and RWKV
layers, and the layer stack."""
