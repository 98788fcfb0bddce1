"""IDEALEM-compressed telemetry ingestion: compress a fleet's channels and
read them back.

The reference package's ``data/pipeline.py`` also holds a prefetching
loader (``Prefetcher``) and mesh placement (``place_on_mesh``); they belong
to the training substrate and are not ported yet (ROADMAP Queue 1 items
12.4 and 12.5).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from ..core import IdealemCodec

__all__ = ["compress_channels", "compressed_telemetry_reader"]


def compressed_telemetry_reader(blobs, codec: IdealemCodec
                                ) -> Iterator[np.ndarray]:
    """Inverse of the ingestion path: decode IDEALEM-compressed channels."""
    for blob in blobs:
        yield codec.decode(blob)


def compress_channels(channels: np.ndarray, codec: IdealemCodec):
    """Compress (C, N) telemetry; returns (blobs, mean compression ratio)."""
    blobs = [codec.encode(ch) for ch in channels]
    ratio = float(np.mean([channels[i].nbytes / len(b)
                           for i, b in enumerate(blobs)]))
    return blobs, ratio
