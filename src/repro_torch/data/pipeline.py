"""Host data pipeline: a prefetching loader and the IDEALEM-compressed
telemetry ingestion path (compress a fleet's channels, read them back).

The reference package's ``data/pipeline.py`` also places batches on a
device mesh (``place_on_mesh``); that waits with the rest of sharding
(``models.common.UNPORTED``).  A ``Prefetcher``'s ``place`` callable can
move each batch to a device.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np

from ..core import IdealemCodec

__all__ = ["Prefetcher", "compress_channels", "compressed_telemetry_reader"]


class Prefetcher:
    """Iterate ``it`` on a background thread, keeping up to ``prefetch``
    items (each passed through ``place``) ready, in order."""

    def __init__(self, it: Iterator, prefetch: int = 2,
                 place: Optional[Callable] = None):
        self._it = it
        self._place = place or (lambda x: x)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(self._place(item))
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


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
