"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  A CUDA
device that is not present is an error, never a silent move to the host.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``.  Raises ``RuntimeError`` for a CUDA device
    when ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available "
            "(torch.cuda.is_available() is False); pass device='cpu' to run "
            "the plain PyTorch versions on the host")
    return dev

