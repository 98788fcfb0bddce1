"""IDEALEM in PyTorch and CUDA: the port of the reference package
``repro`` (JAX/Pallas) to an NVIDIA H100.

Imports ``torch`` and numpy only -- never ``jax`` and nothing of ``repro``.
Entry points run on the card by default (``device="cuda"``) and raise when
no GPU is present; ``device="cpu"`` runs the kernels' plain versions.
"""
from .core import DictState, IdealemCodec, IdealemSession, decode_stream
from .errors import KernelShapeError, StreamFormatError

__all__ = ["IdealemCodec", "IdealemSession", "DictState", "decode_stream",
           "KernelShapeError", "StreamFormatError"]
