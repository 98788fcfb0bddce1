"""CLI over the port's decode-backend autotuner (``repro_torch.core.decode``):
probe the measured-best backend per (mode, dtype, size bucket, device) and
validate a persisted cache.

    python -m repro_torch.launch.autotune_tool probe [--out PATH]
        [--modes std,res,delta] [--dtypes f8] [--buckets 64,1024,16384]
        [--block-size 32] [--device cuda|cpu]
    python -m repro_torch.launch.autotune_tool selfcheck PATH

  probe      time numpy vs torch vs cuda on ``--device`` (default the card)
             for every combination, each device backend first held
             byte-exact against the host path, and persist the versioned
             choice table.  ``--out`` defaults to the file that
             ``REPRO_TORCH_DECODE_AUTOTUNE`` names (else
             ``decode_autotune.json``).
  selfcheck  a persisted cache must (1) strictly reload with every entry
             intact, (2) survive a save/load round trip bit-identically,
             and (3) be REJECTED -- strict load raises, lenient load
             discards and leaves the table cold -- when corrupted or
             carrying a stale version field

The commands and checks are the reference package's
(``scripts/autotune_tool.py``).  The port has no host fallback: a device
backend that is not byte-exact makes ``probe`` fail.

Exit status: 0 clean, 1 failed check, 2 usage.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile


def cmd_probe(args) -> int:
    from repro_torch.core import decode as decode_mod
    modes = {"std": decode_mod.MODE_STD, "res": decode_mod.MODE_RESIDUAL,
             "delta": decode_mod.MODE_DELTA}
    decode_mod.reset_autotune()
    buckets = [int(b) for b in args.buckets.split(",")]
    for mode_name in args.modes.split(","):
        mode = modes[mode_name]
        for dt in args.dtypes.split(","):
            for nb in buckets:
                decode_mod.resolve_backend("auto", mode, dt, nb,
                                           block_size=args.block_size,
                                           device=args.device)
    decode_mod.save_autotune(args.out)
    for key, backend in decode_mod.autotune_choices().items():
        print(f"  {key} -> {backend}")
    stats = decode_mod.decode_stats()
    print(f"probed {stats['autotune_probes']} combination(s) -> {args.out}")
    return 0


def _expect_raise(path, what) -> int:
    """Strict load must raise; lenient load must discard (0 entries)."""
    from repro_torch.core import decode as decode_mod
    try:
        decode_mod.load_autotune(path, strict=True)
    except decode_mod.AutotuneCacheError as e:
        print(f"  {what}: strict load rejected as expected ({e})")
    else:
        print(f"FAIL {what}: strict load accepted an invalid cache")
        return 1
    decode_mod.reset_autotune()
    n = decode_mod.load_autotune(path, strict=False)
    if n != 0 or decode_mod.autotune_choices():
        print(f"FAIL {what}: lenient load kept {n} entries from an "
              f"invalid cache")
        return 1
    print(f"  {what}: lenient load discarded it (cold table, will re-probe)")
    return 0


def cmd_selfcheck(args) -> int:
    from repro_torch.core import decode as decode_mod
    # 1. the persisted cache strictly reloads
    decode_mod.reset_autotune()
    n = decode_mod.load_autotune(args.cache, strict=True)
    if n == 0:
        print(f"FAIL {args.cache}: no entries")
        return 1
    choices = decode_mod.autotune_choices()
    print(f"  loaded {n} entrie(s): {choices}")

    with tempfile.TemporaryDirectory() as td:
        # 2. save -> load round trip preserves every choice
        rt = os.path.join(td, "roundtrip.json")
        decode_mod.save_autotune(rt)
        decode_mod.reset_autotune()
        if decode_mod.load_autotune(rt, strict=True) != n \
                or decode_mod.autotune_choices() != choices:
            print("FAIL round trip changed the choice table")
            return 1
        print("  round trip: identical choice table")

        with open(args.cache, "r", encoding="utf-8") as f:
            doc = json.load(f)

        # 3a. stale version field -> rejected, re-probe path
        stale = os.path.join(td, "stale.json")
        with open(stale, "w", encoding="utf-8") as f:
            json.dump({**doc, "version": doc["version"] + 1}, f)
        if _expect_raise(stale, "stale version"):
            return 1

        # 3b. corrupted bytes -> rejected, re-probe path
        corrupt = os.path.join(td, "corrupt.json")
        with open(args.cache, "rb") as f:
            blob = f.read()
        with open(corrupt, "wb") as f:
            f.write(blob[: max(1, len(blob) // 2)] + b"\xff{garbage")
        if _expect_raise(corrupt, "corrupted file"):
            return 1

        # 3c. structurally wrong entries -> rejected
        malformed = os.path.join(td, "malformed.json")
        with open(malformed, "w", encoding="utf-8") as f:
            json.dump({"version": doc["version"],
                       "entries": {"k": {"backend": "not-a-backend"}}}, f)
        if _expect_raise(malformed, "malformed entry"):
            return 1

    print(f"selfcheck OK: {args.cache}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="autotune_tool")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("probe", help="measure + persist backend choices")
    p.add_argument("--out", default=None,
                   help="cache file (default: $REPRO_TORCH_DECODE_AUTOTUNE, "
                   "else decode_autotune.json)")
    p.add_argument("--modes", default="std,res,delta")
    p.add_argument("--dtypes", default="f8")
    p.add_argument("--buckets", default="64,1024,16384")
    p.add_argument("--block-size", type=int, default=32)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.set_defaults(fn=cmd_probe)

    p = sub.add_parser("selfcheck", help="validate a persisted cache")
    p.add_argument("cache")
    p.set_defaults(fn=cmd_selfcheck)

    args = ap.parse_args(argv)
    if args.cmd == "probe" and args.out is None:
        args.out = (os.environ.get("REPRO_TORCH_DECODE_AUTOTUNE")
                    or "decode_autotune.json")
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
