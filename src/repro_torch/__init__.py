"""IDEALEM in PyTorch and CUDA: the port of the reference package
``repro`` (JAX/Pallas) to an NVIDIA H100.

Imports ``torch`` and numpy only -- never ``jax`` and nothing of ``repro``.
Entry points run on the card by default (``device="cuda"``) and raise when
no GPU is present; ``device="cpu"`` runs the kernels' plain versions.

Curated public surface (``repro_torch.__all__``), following the reference
package's.  Attribute access is lazy (PEP 562): ``import repro_torch``,
``repro_torch.api`` and ``repro_torch.errors`` load no ``torch``; the codec
and device stack loads on first use of a name that needs it.

* ``repro_torch.api``    -- wire-typed requests/responses + ``CodecConfig``
* ``repro_torch.errors`` -- the ``ReproError`` hierarchy + protocol codes
* ``repro_torch.core``   -- codec, sessions, decode engine, KS machinery
* ``repro_torch.store``  -- indexed random-access containers
* ``repro_torch.obs``    -- metrics registry, spans, exporters, SLOs
* ``repro_torch.serve``  -- compression services, LM decode engine
"""
from __future__ import annotations

import importlib

# name -> defining submodule; the curated public surface.
_PUBLIC = {
    # wire API (dependency-light)
    "CodecConfig": "repro_torch.api",
    "CompressRequest": "repro_torch.api",
    "FeedResult": "repro_torch.api",
    "DecodeRangeRequest": "repro_torch.api",
    "RangeResult": "repro_torch.api",
    # error hierarchy
    "ReproError": "repro_torch.errors",
    "StreamFormatError": "repro_torch.errors",
    "ContainerFormatError": "repro_torch.errors",
    "AutotuneCacheError": "repro_torch.errors",
    "KernelShapeError": "repro_torch.errors",
    "ApiError": "repro_torch.errors",
    "AdmissionError": "repro_torch.errors",
    "QuotaExceededError": "repro_torch.errors",
    "RateLimitedError": "repro_torch.errors",
    "OverloadedError": "repro_torch.errors",
    "NotFoundError": "repro_torch.errors",
    # codec core
    "IdealemCodec": "repro_torch.core",
    "IdealemSession": "repro_torch.core",
    "SessionStats": "repro_torch.core",
    "DictState": "repro_torch.core",
    "decode_stream": "repro_torch.core",
    "critical_distance": "repro_torch.core",
    "ks_pvalue": "repro_torch.core",
    # store
    "Container": "repro_torch.store",
    "ContainerWriter": "repro_torch.store",
    "pack": "repro_torch.store",
    "decode_range": "repro_torch.store",
    "decode_ranges": "repro_torch.store",
    "decode_channels": "repro_torch.store",
    # serving
    "FlushPolicy": "repro_torch.serve",
    "CompressionService": "repro_torch.serve",
    "StreamCoalescer": "repro_torch.serve",
    "DecompressionService": "repro_torch.serve",
}

# public submodules, importable both as attributes and as
# ``import repro_torch.x``
_SUBMODULES = ("api", "errors", "core", "store", "obs", "kernels", "models",
               "configs", "serve", "launch", "data")

__all__ = sorted(_PUBLIC) + list(_SUBMODULES)


def __getattr__(name: str):
    target = _PUBLIC.get(name)
    if target is not None:
        value = getattr(importlib.import_module(target), name)
        globals()[name] = value  # cache: next access skips this hook
        return value
    if name in _SUBMODULES:
        module = importlib.import_module(f"repro_torch.{name}")
        globals()[name] = module
        return module
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
