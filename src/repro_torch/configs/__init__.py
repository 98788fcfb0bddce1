"""Architecture registry of the port: the reference's ten architectures
(and the paper's own codec configuration, ``idealem_paper``).

Each module defines ``FULL`` (the published configuration, as in the
reference package's ``repro/configs``) and ``SMOKE`` (a reduced
same-family configuration for CPU tests).  The dry run's shapes are
defined here too: every architecture pairs with train_4k / prefill_32k /
decode_32k / long_500k, the last only for the architectures with
sub-quadratic context handling.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = ["ARCHS", "ALIASES", "ShapeSpec", "SHAPES", "LONG_CONTEXT_OK",
           "get_config", "cells"]

ARCHS = [
    "granite_moe_1b_a400m",
    "mixtral_8x22b",
    "granite_3_8b",
    "gemma3_27b",
    "stablelm_12b",
    "glm4_9b",
    "zamba2_1_2b",
    "rwkv6_3b",
    "llama_3_2_vision_90b",
    "whisper_tiny",
]

# canonical ids (dash form) -> module name
ALIASES = {a.replace("_", "-"): a for a in ARCHS}
ALIASES.update({
    "zamba2-1.2b": "zamba2_1_2b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
})




@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# architectures with sub-quadratic context handling run long_500k; the pure
# full-attention ones skip it
LONG_CONTEXT_OK = {
    "mixtral_8x22b",      # SWA
    "gemma3_27b",         # 5:1 local:global
    "zamba2_1_2b",        # hybrid SSM (+ windowed shared attn)
    "rwkv6_3b",           # attention-free
}


def get_config(arch: str, smoke: bool = False):
    """``FULL`` (or ``SMOKE``) of an architecture, by module name or dash
    alias; ``ValueError`` for a name the registry does not hold."""
    mod_name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if mod_name not in ARCHS:
        raise ValueError(f"unknown architecture {arch!r} (known: "
                         f"{', '.join(ALIASES)})")
    mod = importlib.import_module(f"{__name__}.{mod_name}")
    return mod.SMOKE if smoke else mod.FULL


def cells(arch: Optional[str] = None) -> Tuple[Tuple[str, str], ...]:
    """All (arch, shape) dry-run cells, honoring the long_500k skip list."""
    out = []
    for a in ([ALIASES.get(arch, arch)] if arch else ARCHS):
        for s in SHAPES:
            if s == "long_500k" and a not in LONG_CONTEXT_OK:
                continue
            out.append((a, s))
    return tuple(out)
