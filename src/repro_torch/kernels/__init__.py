"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its plain
PyTorch version: ``encode_step`` (K1, the fused encode scan),
``seq_cumsum`` (K2, the delta-mode decode cumsum), ``dict_match`` (K3,
the ``"ops"`` matcher; public wrappers in ``ops``, plain matching
arithmetic in ``ref``) and ``flash_decode`` (K4, the LM serve path's
decode attention).  Sources live in ``repro_torch/csrc``; ``_build``
compiles them on first use."""
