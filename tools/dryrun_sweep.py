"""The dry run's full sweep, one process a cell (arch x shape x mesh),
several at once, the longest architectures first; no card is used:

    PYTHONPATH=src python3 tools/dryrun_sweep.py --out <dir> [--procs 8]
        [--arch zamba2-1.2b --arch rwkv6-3b] [--cell-timeout 1800]

Prints the wall time, then each cell's status, ``replication`` and
``trace_s``; a cell cut by ``--cell-timeout`` is reported ``timeout`` and
writes no record.  Exits 1 if a cell failed or was cut.
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
from repro_torch.configs import ALIASES, LONG_CONTEXT_OK, SHAPES  # noqa: E402

ARCHS = ("zamba2-1.2b", "rwkv6-3b", "gemma3-27b", "llama-3.2-vision-90b",
         "whisper-tiny", "granite-moe-1b-a400m", "granite-3-8b",
         "mixtral-8x22b", "stablelm-12b", "glm4-9b")


def _tag(arch: str, shape: str, mesh: str) -> str:
    return f"{ALIASES.get(arch, arch)}_{shape}_{mesh}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--procs", type=int, default=8)
    ap.add_argument("--arch", action="append", default=None,
                    help="an architecture to sweep (repeat; default all)")
    ap.add_argument("--cell-timeout", type=float, default=None,
                    help="seconds a cell may trace before it is cut")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    jobs = [(a, s, m) for a in (args.arch or ARCHS) for s in SHAPES
            for m in ("single", "multi")
            if s != "long_500k" or ALIASES.get(a, a) in LONG_CONTEXT_OK]
    cut, running, t0 = [], {}, time.time()
    while jobs or running:
        for job, (proc, start) in list(running.items()):
            if proc.poll() is not None:
                del running[job]
            elif (args.cell_timeout is not None
                  and time.time() - start > args.cell_timeout):
                proc.kill()
                proc.wait()
                cut.append(job)
                del running[job]
        while jobs and len(running) < args.procs:
            arch, shape, mesh = job = jobs.pop(0)
            with open(os.path.join(args.out, _tag(*job) + ".log"),
                      "w") as log:
                running[job] = (subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", shape, "--mesh", mesh,
                     "--out", args.out],
                    stdout=log, stderr=subprocess.STDOUT, env=env),
                    time.time())
        time.sleep(1)
    print(f"sweep wall {time.time() - t0:.0f} s")
    recs = []
    for job in sorted(set((a, s, m) for a in (args.arch or ARCHS)
                          for s in SHAPES for m in ("single", "multi"))):
        path = os.path.join(args.out, _tag(*job) + ".json")
        if job in cut:
            print(*job, "timeout", args.cell_timeout)
        elif os.path.exists(path):
            recs.append(json.load(open(path)))
    for r in recs:
        print(r["arch"], r["shape"], r["mesh"], r["status"],
              r.get("replication", -1), r.get("trace_s", 0),
              r.get("error", "")[:200])
    ok = sum(r["status"] == "ok" for r in recs)
    print(f"sweep {ok} of {len(recs) + len(cut)} ok, {len(cut)} cut; traces "
          f"{sum(r.get('trace_s', 0) for r in recs):.1f} s")
    return 0 if ok == len(recs) and not cut else 1


if __name__ == "__main__":
    raise SystemExit(main())
