"""Typed failures of the PyTorch port.

The port keeps its own copies of the reference package's typed errors so it
imports nothing from it.  Each keeps ``ValueError`` in its bases, so
``except ValueError`` call sites work unchanged.
"""
from __future__ import annotations

__all__ = ["StreamFormatError", "KernelShapeError", "AutotuneCacheError"]


class StreamFormatError(ValueError):
    """Malformed/truncated IDEALEM stream.  ``offset`` is the byte position
    at which parsing failed (raw ``struct.error``/``IndexError`` from the
    walk are never surfaced to callers)."""

    def __init__(self, message: str, offset: int = 0):
        super().__init__(f"{message} (at byte {offset})")
        self.offset = offset


class KernelShapeError(ValueError):
    """An operand's device, dtype, shape or layout violates a kernel's
    contract.  Raised by the kernel wrappers before any launch, with the
    offending dimensions in the message."""


class AutotuneCacheError(ValueError):
    """A persisted autotune cache failed validation (corrupt JSON, wrong
    structure, or a stale ``version`` field)."""
