"""The LM serve path's models (dense decoders): config, layers, attention
with the K4 decode kernel, and the layer stack."""
