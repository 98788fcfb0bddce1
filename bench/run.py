"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The cell
(``workloads`` there) names a configuration (``bench/configs/``) and a
traffic mix (``bench/traffic/``); the mix's ``kind`` picks its runner
(``bench/harness/<kind>.py``).  A run makes its inputs on the card from
the seed, warms up, measures for ``--seconds``, checks what the window
produced against the plain reference (``bench/reference/``) and prints
one JSON line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics,
each read by ``bench/metrics/<name>.py``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
as the last lines of standard error say too.

It needs a CUDA card (no CPU fallback) and exits non-zero without a
result when there is none, when the checkout lacks the port, or when the
process holds JAX or the JAX package after the window.

``--control float32`` puts the reference, computed in float32, in the
program's place for the check (the control of the comparison; the
benchmark's own runs never pass it).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "bench-cache"


def _environment() -> None:
    """Caches inside the checkout, at fixed paths."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("float32",), default=None)
    args = ap.parse_args(argv)
    _environment()

    import torch
    from bench.harness.core import Bench, forbidden_modules
    from bench.harness.env import run_cell

    bench = Bench(HERE)
    chips = int(bench.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("bench: no src/repro_torch in this checkout", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    line, checks = run_cell(torch, dev, bench, args.workload, args.seed,
                            args.seconds, bool(args.trace), T_START,
                            control=args.control, chips=chips)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the process holds {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    for c in checks:
        print(c, file=sys.stderr)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
