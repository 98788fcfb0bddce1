"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``src/repro_torch/csrc/<name>.cu`` has a plain C interface (no
PyTorch headers, so each compiles in seconds) and becomes
``build/kernels/lib<name>.so`` under the checkout root, a git-ignored
directory.  A source is rebuilt when its library is missing or older than
the source or a shared header (``csrc/*.cuh``); all stale sources compile
at once, one ``nvcc`` process each.
Each build's compiler output (``-Xptxas=-v``: registers, shared memory,
spills) is kept beside the library as ``<name>.log``.

Nothing here runs at import time: a kernel module calls :func:`load` the
first time its wrapper launches on a CUDA tensor.  :func:`load` holds a
lock across its lookup, build and ``dlopen``, so a first use from two
threads (a pipelined service's worker and its caller) builds and loads a
library once; :func:`count_launch` bumps a wrapper's launch counter under
a lock of its own, so counts stay exact when two threads launch.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

__all__ = ["CSRC_DIR", "BUILD_DIR", "build_all", "load", "build_log",
           "count_launch", "cost_counters", "report_cost"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# K1's and K3's results hinge on single-rounded f32 products and
# differences (the eq. 3 gate and the ECDF gaps): nvcc must not contract
# them into FMAs.
EXTRA_FLAGS = {"encode_step": ("-fmad=false",),
               "dict_match": ("-fmad=false",)}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "port's CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build_log(name: str) -> str:
    """The compiler output of the last build of ``csrc/<name>.cu``."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def _stale(src: Path) -> bool:
    """The library is missing or older than its source or a shared header
    (``csrc/*.cuh``)."""
    lib = _lib_path(src.stem)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in (src, *CSRC_DIR.glob("*.cuh")))
    return lib.stat().st_mtime < newest


def build_all(force: bool = False) -> Dict[str, float]:
    """Compile every stale (or, with ``force``, every) source in parallel.

    Returns ``{name: seconds}`` for the sources it compiled.  Raises
    ``RuntimeError`` with the compiler output if any build fails, after
    every ``nvcc`` it started has exited.
    """
    srcs = [s for s in sorted(CSRC_DIR.glob("*.cu")) if force or _stale(s)]
    if not srcs:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in srcs:
        name = src.stem
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-o", str(tmp),
               str(src)]
        jobs.append((name, tmp, log, time.perf_counter(),
                     subprocess.Popen(cmd, stdout=log,
                                      stderr=subprocess.STDOUT)))
    times, failed = {}, []
    for name, tmp, log, t0, proc in jobs:
        rc = proc.wait()
        log.close()
        times[name] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, _lib_path(name))
        else:
            failed.append(f"nvcc failed for {name}.cu (rc={rc}):\n"
                          f"{build_log(name)}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if stale."""
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            src = CSRC_DIR / f"{name}.cu"
            if not src.exists():
                raise FileNotFoundError(f"no kernel source {src}")
            if _stale(src):
                build_all()
            lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib


#: Active cost counters (``launch.hlo_cost.CostCounter`` adds itself while
#: it counts); a kernel, which no dispatch mode sees, reports to them.
cost_counters: list = []


def report_cost(flops: float, nbytes: float) -> None:
    """A kernel's reckoned FLOPs and bytes, to every active counter."""
    for counter in cost_counters:
        counter.add(flops, nbytes)


def count_launch(module) -> None:
    """Add one to ``module.launches`` (a kernel wrapper's counter)."""
    with _COUNT_LOCK:
        module.launches += 1
