"""Host cost of the port's step telemetry (``repro_torch.obs``).

    PYTHONPATH=src python3 tools/span_cost.py [--n 200000] [--repeats 5]

Times, on a private tracer and registry, an empty ``with`` over a null
context (the baseline), ``span(name)``, ``span(name, seconds=hist)`` with
the tracer on and off, a bare ``observe``, and the chunk walk's stamp
pair with its ``observe``.  Prints one JSON line: microseconds a call,
the best of ``--repeats`` runs of ``--n`` calls each, baseline included
(subtract it for the telemetry's own cost).  Run it on the machine whose
host the numbers describe.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import platform
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.obs import MetricsRegistry, SpanTracer  # noqa: E402


def _best_us(fn, n: int, repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(n)
        best = min(best, time.perf_counter() - t0)
    return best / n * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    reg = MetricsRegistry()
    hist = reg.histogram("t_step_seconds", labels={"step": "x"})
    on, off = SpanTracer(), SpanTracer(enabled=False)

    def baseline(n):
        for _ in range(n):
            with contextlib.nullcontext():
                pass

    def span_only(n):
        for _ in range(n):
            with on.span("t.step"):
                pass

    def span_seconds(tracer):
        def run(n):
            for _ in range(n):
                with tracer.span("t.step", seconds=hist):
                    pass
        return run

    def observe(n):
        for _ in range(n):
            hist.observe(1e-5)

    def walk_stamp(n):
        for _ in range(n):
            t0 = time.perf_counter()
            hist.observe(time.perf_counter() - t0)

    rows = {"baseline_us": baseline, "span_us": span_only,
            "span_seconds_on_us": span_seconds(on),
            "span_seconds_off_us": span_seconds(off),
            "observe_us": observe, "walk_stamp_observe_us": walk_stamp}
    out = {k: _best_us(fn, args.n, args.repeats) for k, fn in rows.items()}
    out.update(n=args.n, repeats=args.repeats, python=sys.version.split()[0],
               machine=platform.machine(), processor=platform.processor())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
