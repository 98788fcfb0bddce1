"""Architecture registry of the port: the reference's ten architectures.

Each module defines ``FULL`` (the published configuration, as in the
reference package's ``repro/configs``) and ``SMOKE`` (a reduced
same-family configuration for CPU tests).
"""
from __future__ import annotations

import importlib

__all__ = ["ARCHS", "ALIASES", "get_config"]

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


def get_config(arch: str, smoke: bool = False):
    """``FULL`` (or ``SMOKE``) of an architecture, by module name or dash
    alias; ``ValueError`` for a name the registry does not hold."""
    mod_name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if mod_name not in ARCHS:
        raise ValueError(f"unknown architecture {arch!r} (known: "
                         f"{', '.join(ALIASES)})")
    mod = importlib.import_module(f"{__name__}.{mod_name}")
    return mod.SMOKE if smoke else mod.FULL
