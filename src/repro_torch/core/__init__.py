"""IDEALEM core: statistical-similarity data reduction (the paper's
contribution) -- codec, streaming session, encoder scan, stream format,
decode engine and the quality measures."""
from .decode import BACKENDS as DECODE_BACKENDS
from .decode import DecodePlan, decode_stats, reconstruct
from .encoder import (DictState, encode_decisions, encode_decisions_batched,
                      init_state, state_from_numpy, state_to_numpy)
from .idealem import ENCODE_BACKENDS, IdealemCodec
from .ks import critical_distance, ks_pvalue, ks_statistic_many
from .metrics import amplitude_spectrum, quality_measures, spectral_band_error
from .session import IdealemSession, PreparedChunk, SessionStats
from .stream import decode_stream, parse_stream

__all__ = [
    "IdealemCodec", "IdealemSession", "PreparedChunk", "SessionStats",
    "ENCODE_BACKENDS", "DECODE_BACKENDS", "DecodePlan", "reconstruct",
    "decode_stats", "decode_stream", "parse_stream", "DictState",
    "init_state", "state_from_numpy", "state_to_numpy", "encode_decisions",
    "encode_decisions_batched", "critical_distance", "ks_pvalue",
    "ks_statistic_many", "quality_measures", "amplitude_spectrum",
    "spectral_band_error",
]
