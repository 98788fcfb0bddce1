"""CLI over the port's telemetry layer (``repro_torch.obs``).

    python -m repro_torch.launch.obs_tool dump [--format prom|json]
        [--no-workload] [--device cuda|cpu]
    python -m repro_torch.launch.obs_tool slo SCRAPE
        NAME:QUANTILE:MAX[:k=v,...] ...
    python -m repro_torch.launch.obs_tool selfcheck [--device cuda|cpu]

  dump       exercise a small end-to-end workload (coalesced encode ->
             packed container -> pipelined range decode, on ``--device``,
             default the card) against the port's process-default registry
             and print the resulting snapshot as Prometheus text exposition
             (default) or JSON.
  slo        evaluate latency objectives against a scraped exposition file
             (``-`` reads stdin) -- the gate a serving soak runs on the
             load generator's /metrics snapshot.
  selfcheck  (1) the exporter round trip on a scratch registry covering all
             three instrument kinds, awkward label escapes included; (2)
             the live end-to-end: the workload above must populate the
             expected ``repro_<layer>_<name>`` metric families across
             encode, decode, store and serving from ONE registry snapshot,
             the exposition must parse back value-exact, and the span ring
             must hold all four serve stages.

The commands and checks are the reference package's
(``scripts/obs_tool.py``), over the port's own registry and tracer.

Exit status: 0 clean, 1 failed check, 2 usage.
"""
from __future__ import annotations

import argparse
import sys

# one metric family per wired layer
EXPECTED_FAMILIES = (
    "repro_encode_bytes_in_total",        # session ingest
    "repro_encode_bytes_out_total",
    "repro_encode_blocks_total",
    "repro_encode_hits_total",
    "repro_encode_flushes_total",         # coalescer device batches
    "repro_encode_flush_seconds",
    "repro_decode_host_calls_total",      # unified decode engine
    "repro_decode_backend_calls_total",
    "repro_store_chunk_walks_total",      # container read path
    "repro_store_range_requests_total",
    "repro_serve_requests_total",         # serving
    "repro_serve_stage_seconds",
    "repro_serve_cache_hits_total",
)
EXPECTED_STAGES = ("plan", "gather", "reconstruct", "emit")


def run_workload(device: str = "cuda") -> None:
    """Small but complete traffic on ``device``: many coalesced streams
    flushed as one device batch (K1), packed into a container,
    range-decoded through a pipelined ``DecompressionService``."""
    import numpy as np

    from repro_torch.serve import (DecompressionService, FlushPolicy,
                                   StreamCoalescer)
    from repro_torch.store import Container, pack

    rng = np.random.default_rng(0)
    coal = StreamCoalescer(
        policy=FlushPolicy(max_batch_blocks=64, max_batch_streams=4),
        mode="std", block_size=16, num_dict=8, device=device)
    blobs = {}
    for sid in ("a", "b", "c"):
        coal.open_stream(sid)
        blobs[sid] = b""
    for _ in range(4):
        for sid in blobs:
            out = coal.submit(sid, rng.normal(0, 1, size=64)) or {}
            for k, seg in out.items():
                blobs[k] += seg
    for sid in list(blobs):
        blobs[sid] += coal.close_stream(sid)

    svc = DecompressionService(
        policy=FlushPolicy(max_batch_streams=4, pipeline_depth=2),
        device=device)
    svc.attach("s", Container(pack(blobs["a"])))
    for i, (start, stop) in enumerate([(0, 4), (4, 8), (2, 10), (0, 16)]):
        svc.submit(f"r{i}", "s", start, stop)
    svc.close()


def check_live(device: str = "cuda") -> list:
    from repro_torch import obs
    problems = []
    reg = obs.registry()
    run_workload(device)
    snap = reg.snapshot()
    for fam in EXPECTED_FAMILIES:
        if fam not in snap:
            problems.append(f"metric family missing after workload: {fam}")
    stage_hist = snap.get("repro_serve_stage_seconds", {"values": []})
    seen = {v["labels"].get("stage") for v in stage_hist["values"]
            if v.get("count", 0) > 0}
    for stage in EXPECTED_STAGES:
        if stage not in seen:
            problems.append(f"stage histogram never observed: {stage}")
    span_names = {s.name for s in obs.tracer().records(kind="span")}
    for stage in EXPECTED_STAGES:
        if f"serve.{stage}" not in span_names:
            problems.append(f"span ring missing serve.{stage}")
    if "encode.flush" not in span_names:
        problems.append("span ring missing encode.flush")
    problems.extend(obs.selfcheck(reg))
    return problems


def cmd_dump(args) -> int:
    from repro_torch import obs
    if not args.no_workload:
        run_workload(args.device)
    if args.format == "json":
        import json
        json.dump(obs.to_json(), sys.stdout, indent=1, sort_keys=True)
        print()
    else:
        sys.stdout.write(obs.to_prometheus())
    return 0


def cmd_selfcheck(args) -> int:
    from repro_torch import obs
    problems = obs.selfcheck()  # scratch registry: exporter round trip
    if not problems:
        print("exporter round trip: OK")
    problems += check_live(args.device)
    if problems:
        for p in problems:
            print(f"FAIL: {p}")
        return 1
    print(f"live end-to-end on {args.device}: OK ({len(EXPECTED_FAMILIES)} "
          f"families, {len(EXPECTED_STAGES)} stage histograms, spans "
          "present)")
    return 0


def cmd_slo(args) -> int:
    """Evaluate ``NAME:QUANTILE:MAX[:k=v,...]`` specs against a scraped
    exposition file (``-`` = stdin) -- the same estimator the load
    generator and the front end's control loop use."""
    from repro_torch import obs
    if args.scrape == "-":
        text = sys.stdin.read()
    else:
        with open(args.scrape) as fh:
            text = fh.read()
    parsed = obs.parse_prometheus(text)
    specs = []
    for raw in args.spec:
        parts = raw.split(":")
        if len(parts) not in (3, 4):
            print(f"bad spec {raw!r}: NAME:QUANTILE:MAX[:k=v,...]",
                  file=sys.stderr)
            return 2
        labels = {}
        if len(parts) == 4 and parts[3]:
            for kv in parts[3].split(","):
                k, _, v = kv.partition("=")
                labels[k] = v
        specs.append(obs.SloSpec(parts[0], float(parts[1]), float(parts[2]),
                                 labels))
    failed = 0
    for res in obs.evaluate_slos(specs, parsed=parsed):
        print(res.describe())
        if not res.ok or (args.require_traffic and res.value is None):
            failed += 1
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="obs_tool")
    sub = ap.add_subparsers(dest="cmd")
    d = sub.add_parser("dump", help="exercise a workload and print metrics")
    d.add_argument("--format", choices=("prom", "json"), default="prom")
    d.add_argument("--no-workload", action="store_true",
                   help="dump the registry as-is, without traffic")
    d.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    c = sub.add_parser("selfcheck",
                       help="exporter round trip + live e2e check")
    c.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    s = sub.add_parser("slo", help="evaluate SLO specs against a scrape")
    s.add_argument("scrape", help="Prometheus exposition file, or - (stdin)")
    s.add_argument("spec", nargs="+",
                   help="NAME:QUANTILE:MAX[:k=v,...], e.g. "
                   "repro_frontend_request_seconds:0.99:0.5:"
                   "route=POST /v1/feed")
    s.add_argument("--require-traffic", action="store_true",
                   help="an absent/empty histogram fails instead of "
                   "passing vacuously")
    args = ap.parse_args(argv)
    if args.cmd == "dump":
        return cmd_dump(args)
    if args.cmd == "selfcheck":
        return cmd_selfcheck(args)
    if args.cmd == "slo":
        return cmd_slo(args)
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
