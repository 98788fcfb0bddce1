#!/usr/bin/env python3
"""Digest the SASS of the port's CUDA kernels, to show that a change left a
kernel's machine code as it was.

For each checkout root given (default: this one), compiles
``src/repro_torch/csrc/<name>.cu`` to a cubin with the flags of
``repro_torch/kernels/_build.py``, disassembles it with ``cuobjdump -sass``
and prints one line per kernel function: the source, the function's name
with its anonymous-namespace hash removed, its instruction count and the
md5 of its instruction text (addresses stripped).  Two checkouts whose
lines match compile a kernel to the same instructions.  Needs ``nvcc`` and
``cuobjdump`` (the CUDA toolkit), so it runs on the machine with the card:

    python3 scripts/sass_digest.py [ROOT ...] [--kernels encode_step,dict_match]
"""
from __future__ import annotations

import argparse
import hashlib
import re
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE / "src"))

from repro_torch.kernels import _build  # noqa: E402


def digest(root: Path, name: str):
    """``[(function, instructions, md5)]`` of ``csrc/<name>.cu`` under
    ``root``."""
    src = root / "src" / "repro_torch" / "csrc" / f"{name}.cu"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                       "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / f"{name}.cubin"
        subprocess.run([_build._nvcc(), *flags, *_build.EXTRA_FLAGS.get(
            name, ()), "-cubin", "-o", str(cubin), str(src)], check=True,
            capture_output=True)
        dump = subprocess.run(
            [str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass",
             str(cubin)], check=True, capture_output=True, text=True).stdout
    out, fn, ins = [], None, []
    for line in dump.splitlines() + ["Function : <end>"]:
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if fn is not None:
                out.append((re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", fn),
                            len(ins), hashlib.md5(
                                "\n".join(ins).encode()).hexdigest()))
            fn, ins = m.group(1), []
        elif fn is not None and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            ins.append(line.split("*/", 1)[1].split(";")[0].strip())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", default=[str(HERE)])
    ap.add_argument("--kernels", default="encode_step,dict_match")
    args = ap.parse_args()
    for root in args.roots:
        for name in args.kernels.split(","):
            for fn, n, md5 in digest(Path(root), name):
                print(f"{root} {name}.cu {fn} {n} {md5}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
