"""The readers of the program's step histograms and padding counters on
fixed ``Readings``: each gives its share of the window (or of the padded
cells and rows) from ``registry_delta``, and ``None`` when the run holds
none of its keys (a checkout whose program lacks them) or no device trace
(a run off the card)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench.harness.core import Readings, load_metric  # noqa: E402

METRICS = ROOT / "bench"
ENC = "repro_encode_flush_step_seconds{step=%s}.sum"
DEC = "repro_decode_step_seconds{step=%s}.sum"

# a 2-s window; seconds of each step over it
REGISTRY = {
    ENC % "take": 0.02, ENC % "prepare": 0.5, ENC % "stage": 0.18,
    ENC % "h2d": 0.06, ENC % "scan": 0.05, ENC % "d2h": 0.03,
    ENC % "commit": 0.4,
    "repro_encode_flush_cells_total": 1024 * 256 * 3,
    "repro_encode_flush_blocks.sum": 1020 * 225 * 3,
    "repro_store_chunk_walk_seconds.sum": 0.8,
    DEC % "perms": 0.3, DEC % "h2d": 0.04, DEC % "launch": 0.01,
    DEC % "d2h": 0.05,
    "repro_decode_rows_total{kind=dispatched}": 4096.0,
    "repro_decode_rows_total{kind=requested}": 3072.0,
}

# (metric, expected value, the keys it needs)
CASES = [
    ("prepare_share.ingest", 25.0, [ENC % "prepare"]),
    ("commit_share.ingest", 20.0, [ENC % "commit"]),
    ("staging_share.ingest", 10.0, [ENC % "take", ENC % "stage"]),
    ("flush_wait_share.ingest", 7.0,
     [ENC % "h2d", ENC % "scan", ENC % "d2h"]),
    ("k1_pad_pct.ingest", 100.0 * (1 - 1020 * 225 / (1024 * 256)),
     ["repro_encode_flush_cells_total", "repro_encode_flush_blocks.sum"]),
    ("walk_share.read", 40.0, ["repro_store_chunk_walk_seconds.sum"]),
    ("perms_share.read", 15.0, [DEC % "perms"]),
    ("decode_wait_share.read", 5.0,
     [DEC % "h2d", DEC % "launch", DEC % "d2h"]),
    ("decode_pad_pct.read", 25.0,
     ["repro_decode_rows_total{kind=dispatched}",
      "repro_decode_rows_total{kind=requested}"]),
]


def _readings(registry, host_s=None, device_events=(("k", 10.1, 10.2),)):
    return Readings(cell="c", kind="ingest", config={}, traffic={},
                    setup_s=1.0, window=(10.0, 12.0),
                    registry_delta=dict(registry), host_s=host_s or {},
                    device_events=None if device_events is None
                    else list(device_events))


@pytest.mark.parametrize("name,want,keys", CASES,
                         ids=[c[0] for c in CASES])
def test_reader_value(name, want, keys):
    read = load_metric(METRICS, name)
    assert read(_readings(REGISTRY)) == pytest.approx(want)
    assert read(_readings({k: REGISTRY[k] for k in keys})) == \
        pytest.approx(want)


@pytest.mark.parametrize("name,want,keys", CASES,
                         ids=[c[0] for c in CASES])
def test_reader_without_its_keys_is_none(name, want, keys):
    read = load_metric(METRICS, name)
    assert read(_readings({})) is None
    assert read(_readings(REGISTRY, device_events=None)) is None
    for k in keys:
        assert read(_readings({j: v for j, v in REGISTRY.items()
                               if j != k})) is None


def test_flush_wait_leaves_out_the_k1_capture():
    read = load_metric(METRICS, "flush_wait_share.ingest")
    r = _readings(REGISTRY, host_s={"trace.k1_capture": 0.04,
                                    "session.prepare": 1.0})
    assert read(r) == pytest.approx(100.0 * (0.14 - 0.04) / 2.0)


def test_pad_readers_need_some_padded_work():
    for name, key in (("k1_pad_pct.ingest",
                       "repro_encode_flush_cells_total"),
                      ("decode_pad_pct.read",
                       "repro_decode_rows_total{kind=dispatched}")):
        assert load_metric(METRICS, name)(
            _readings({**REGISTRY, key: 0.0})) is None
