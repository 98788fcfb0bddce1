"""Count saved dry-run cells again without tracing: reads each
``<tag>.ops.jsonl.gz`` beside an ``ok`` ``<tag>.json`` and rewrites the
record's ``flops_per_chip``, ``bytes_per_chip``, ``collectives``,
``collective_wire_bytes_per_chip`` and ``replication``.

The counterpart of ``scripts/reanalyze.py`` (which re-runs the HLO
analysis over ``<tag>.hlo.zst``).  Each logged event goes through
``launch/hlo_cost.py:event_cost``, the function the trace counted it
with, and the traces are extrapolated to the full step as
``launch/dryrun.py:count_cell`` extrapolates them, so with unchanged
rules every field comes back exactly as the trace wrote it.

  PYTHONPATH=src python -m repro_torch.launch.reanalyze [DIR]
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import sys
from typing import Any, Dict, Iterator, List, Tuple

from .dryrun import _extrapolate, _flat
from .hlo_cost import Tally

__all__ = ["read_traces", "reanalyze_record", "main"]


def read_traces(path: str) -> Iterator[Tuple[dict, Tally]]:
    """(the closing line's ``trace`` dict, the counts of its events) of
    each trace in an op log."""
    tally = Tally()
    with gzip.open(path, "rt") as f:
        for line in f:
            ev = json.loads(line)
            if "trace" in ev:
                yield ev["trace"], tally
                tally = Tally()
            else:
                tally.add_event(ev)


def _counts(traces: List[Tuple[dict, Tally]]) -> Dict[str, Any]:
    points = []
    for head, tally in traces:
        res = tally.result()
        res["argument_size_in_bytes"] = head["argument_size_in_bytes"]
        res["output_size_in_bytes"] = head["output_size_in_bytes"]
        points.append((tuple(head["repeats"]), head["microbatches"],
                       _flat(res)))
    head = traces[0][0]
    return _extrapolate(points, tuple(head["full"]), head["mb"])


def reanalyze_record(rec: dict, log_path: str) -> dict:
    """``rec`` with its counted fields rewritten from its op log."""
    traces = list(read_traces(log_path))
    counts = _counts([t for t in traces if t[0]["mesh"]])
    whole = _counts([t for t in traces if not t[0]["mesh"]])
    rec = dict(rec)
    rec["flops_per_chip"] = counts["flops"]
    rec["bytes_per_chip"] = counts["bytes"]
    rec["collectives"] = counts["collectives"]
    rec["collective_wire_bytes_per_chip"] = counts["collective_wire_bytes"]
    rec["replication"] = counts["flops"] * rec["chips"] / whole["flops"]
    return rec


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    art_dir = argv[0] if argv else "artifacts/dryrun"
    for jf in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        lf = jf[:-len(".json")] + ".ops.jsonl.gz"
        if not os.path.exists(lf):
            continue
        with open(jf) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            continue
        rec = reanalyze_record(rec, lf)
        with open(jf, "w") as f:
            json.dump(rec, f, indent=1)
        print("reanalyzed", os.path.basename(jf))
    return 0


if __name__ == "__main__":
    sys.exit(main())
