"""Architecture registry of the port: the dense decoders it serves.

Each module defines ``FULL`` (the published configuration, as in the
reference package's ``repro/configs``) and ``SMOKE`` (a reduced
same-family configuration for CPU tests).  The reference's other
architectures (moe, ssm, hybrid, vlm, audio, and gemma3's banded prefill)
are not ported yet: :func:`get_config` raises for them.
"""
from __future__ import annotations

import importlib

from ..models.common import UNPORTED

__all__ = ["ARCHS", "ALIASES", "get_config"]

ARCHS = ["granite_3_8b", "glm4_9b", "stablelm_12b"]

# canonical ids (dash form) -> module name
ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def get_config(arch: str, smoke: bool = False):
    """``FULL`` (or ``SMOKE``) of a ported architecture, by module name or
    dash alias; ``NotImplementedError`` for any other."""
    mod_name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if mod_name not in ARCHS:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported (ported: "
            f"{', '.join(ALIASES)}): see {UNPORTED}")
    mod = importlib.import_module(f"{__name__}.{mod_name}")
    return mod.SMOKE if smoke else mod.FULL
