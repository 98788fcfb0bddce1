"""The dry run's full sweep, one process an (arch, mesh), several at once,
the longest first; no card is used:

    PYTHONPATH=src python3 tools/dryrun_sweep.py --out <dir> [--procs 8]

Prints the wall time, then each record's status, ``replication`` and
``trace_s``.  Exits 1 if a cell failed.
"""
import argparse
import glob
import json
import os
import subprocess
import sys
import time

ARCHS = ("zamba2-1.2b", "rwkv6-3b", "gemma3-27b", "llama-3.2-vision-90b",
         "whisper-tiny", "granite-moe-1b-a400m", "granite-3-8b",
         "mixtral-8x22b", "stablelm-12b", "glm4-9b")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--procs", type=int, default=8)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    jobs = [(a, m) for a in ARCHS for m in ("single", "multi")]
    running, t0 = [], time.time()
    while jobs or running:
        running = [p for p in running if p.poll() is None]
        while jobs and len(running) < args.procs:
            arch, mesh = jobs.pop(0)
            with open(os.path.join(args.out, f"{arch}_{mesh}.log"), "w") as log:
                running.append(subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--mesh", mesh, "--out", args.out],
                    stdout=log, stderr=subprocess.STDOUT, env=env))
        time.sleep(1)
    print(f"sweep wall {time.time() - t0:.0f} s")
    recs = [json.load(open(f))
            for f in sorted(glob.glob(os.path.join(args.out, "*.json")))]
    for r in recs:
        print(r["arch"], r["shape"], r["mesh"], r["status"],
              "%.4f" % r.get("replication", -1), "%.1f" % r.get("trace_s", 0),
              r.get("error", "")[:200])
    ok = sum(r["status"] == "ok" for r in recs)
    print(f"sweep {ok} of {len(recs)} ok; traces "
          f"{sum(r.get('trace_s', 0) for r in recs):.1f} s")
    return 0 if ok == len(recs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
