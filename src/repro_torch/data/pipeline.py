"""Host data pipeline: a prefetching loader, batch placement on a device
mesh, and the IDEALEM-compressed telemetry ingestion path (compress a
fleet's channels, read them back).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..core import IdealemCodec

__all__ = ["Prefetcher", "place_on_mesh", "compress_channels",
           "compressed_telemetry_reader"]


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


def place_on_mesh(mesh, batch_axes=("data",)):
    """A ``place`` callable (for :class:`Prefetcher`) that shards each
    tensor of a dict batch along dim 0 over ``batch_axes`` of ``mesh`` (a
    ``torch.distributed`` ``DeviceMesh``) and replicates it over the other
    axes: a dict of ``DTensor``s on the mesh's device type."""
    from torch.distributed.tensor import distribute_tensor

    from ..launch.sharding import P, to_placements
    placements = to_placements(P(tuple(batch_axes)), mesh)

    def place(batch):
        return {k: distribute_tensor(torch.as_tensor(v), mesh, placements)
                for k, v in batch.items()}

    return place


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
