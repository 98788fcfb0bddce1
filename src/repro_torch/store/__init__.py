"""Indexed decode store: random-access containers over IDEALEM streams.

The write side (``repro_torch.core.session``) emits append-mode segment
streams; this package is the symmetric read side:

  container  -- ``.idlm``-wrapping container format with a footer index
                (per-segment offsets, cumulative block counts, FIFO fill
                counters, dictionary snapshots, restart points) and
                ``pack``/``ContainerWriter`` writers + a strict reader;
  reader     -- ``decode_range``/``decode_ranges``/``decode_channels``:
                seek via the index, walk only the covering segments, and
                rebuild in one padded batch -- byte-identical to the
                corresponding slice of a full ``decode_stream``.
"""
from .container import (Container, ContainerFormatError, ContainerWriter,
                        pack)
from .reader import (ParsedChunk, decode_channels, decode_range,
                     decode_ranges, gather_parts, parse_chunk, plan_parts,
                     plan_windows)

__all__ = [
    "Container",
    "ContainerFormatError",
    "ContainerWriter",
    "pack",
    "ParsedChunk",
    "parse_chunk",
    "plan_windows",
    "gather_parts",
    "plan_parts",
    "decode_range",
    "decode_ranges",
    "decode_channels",
]
