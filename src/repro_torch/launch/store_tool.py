"""CLI over the port's indexed decode store (``repro_torch.store``): pack
raw ``.idlm`` streams into random-access containers, inspect their index,
extract decoded ranges, and self-check range-decode equivalence.

    python -m repro_torch.launch.store_tool <command> ...

  pack      out.idlmc stream.idlm [stream2.idlm ...]   (file i -> channel i)
  inspect   container.idlmc [--chunks] [--mmap]
  extract   container.idlmc [--channel C] [--blocks i:j] [-o out.npy]
            [--mmap] [--backend numpy|torch|cuda] [--device cuda|cpu]
  selfcheck stream.idlm [...] [--mmap] [--backend ...] [--device ...]
            pack each stream, then verify decode_range equals the matching
            slice of the host's sequential full decode for a sweep of
            ranges; --mmap round-trips through a file-backed
            memory-mapped open
  bigcheck  [--mb N] [--mmap/--no-mmap] [--out path] [--backend ...]
            [--device ...]   generate a synthetic multi-channel archive of
            ~N MB on disk, open it memory-mapped and verify sampled
            channels/ranges -- the ">RAM-budget archive" exercise
            (per-channel verification stays small no matter how big the
            file is)

Reads default to ``--backend cuda`` on ``--device cuda`` (the card);
``--device cpu`` runs the tensor backends on the host.  The commands and
checks are the reference package's (``scripts/store_tool.py``); the
ground truth of every check is the host (``numpy``) decode.

Exit status: 0 clean, 1 failed check, 2 usage.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

READ_BACKENDS = ("numpy", "torch", "cuda")


def _open(path, use_mmap):
    from repro_torch.store import Container
    return Container.open(path, mmap=use_mmap)


def cmd_pack(args) -> int:
    from repro_torch.store import Container, pack
    streams = {}
    for ch, path in enumerate(args.streams):
        with open(path, "rb") as f:
            streams[ch] = f.read()
    pack(streams, path=args.out)
    store = Container.open(args.out)
    print(f"packed {len(streams)} stream(s) -> {args.out} "
          f"({store.n_chunks} chunks, {os.path.getsize(args.out)} bytes)")
    return 0


def cmd_inspect(args) -> int:
    store = _open(args.container, args.mmap)
    info = store.describe()
    print(f"container: {args.container}" + (" (mmap)" if args.mmap else ""))
    print(f"  chunks={info['chunks']} data_bytes={info['data_bytes']} "
          f"index_bytes={info['index_bytes']} "
          f"snapshot_deltas={info['snapshot_delta_entries']}"
          f"/{info['snapshot_entries']}")
    for c, ci in sorted(info["channels"].items()):
        print(f"  channel {c}: segments={ci['segments']} "
              f"blocks={ci['blocks']} tail={ci['tail_samples']} "
              f"mode={ci['mode']} B={ci['block_size']} D={ci['num_dict']} "
              f"dtype={ci['dtype']} finished={ci['finished']}")
    if args.chunks:
        cols = store._cols
        print("  chunk channel offset length blocks blocks_before fill "
              "flags restart snap_delta")
        for k in range(store.n_chunks):
            print("  " + " ".join(
                str(int(cols[name][k]))
                for name in ("channel", "offset", "length", "n_blocks",
                             "blocks_before", "fill_in", "flags", "restart",
                             "snap_delta")))
    store.close()
    return 0


def _parse_range(spec, total):
    if spec is None:
        return 0, total
    lo, _, hi = spec.partition(":")
    return int(lo or 0), int(hi or total)


def cmd_extract(args) -> int:
    from repro_torch.store import decode_channels, decode_range
    store = _open(args.container, args.mmap)
    if args.blocks is None:
        # whole channel(s), tail included
        chans = store.channels if args.channel is None else [args.channel]
        out = decode_channels(store, chans, backend=args.backend,
                              device=args.device)
        arr = (np.stack([out[c] for c in chans]) if len(chans) > 1
               else out[chans[0]])
    else:
        channel = args.channel or 0
        i, j = _parse_range(args.blocks, store.total_blocks(channel))
        arr = decode_range(store, i, j, channel=channel,
                           backend=args.backend, device=args.device)
    store.close()
    if args.output:
        np.save(args.output, arr)
        print(f"wrote {arr.shape} {arr.dtype} -> {args.output}")
    else:
        np.savetxt(sys.stdout, np.atleast_2d(arr), fmt="%.17g")
    return 0


def _check_ranges(store, y, ranges, path, args, channel=0) -> int:
    from repro_torch.store import decode_range
    B = store.header_of(int(store.chunks_of(channel)[0])).block_size
    bad = 0
    for i, j in ranges:
        got = decode_range(store, i, j, channel=channel,
                           backend=args.backend, device=args.device)
        if not np.array_equal(got, y[i * B:j * B]):
            bad += 1
            print(f"  MISMATCH {path} channel {channel} blocks [{i}, {j})")
    return bad


def cmd_selfcheck(args) -> int:
    from repro_torch.core.stream import decode_stream
    from repro_torch.store import Container, pack
    failures = 0
    for path in args.streams:
        with open(path, "rb") as f:
            data = f.read()
        y = decode_stream(data, backend="numpy")
        if args.mmap:
            with tempfile.NamedTemporaryFile(suffix=".idlmc",
                                             delete=False) as tf:
                tmp = tf.name
            try:
                pack(data, path=tmp)
                store = Container.open(tmp, mmap=True)
                bad = _run_selfcheck(store, y, path, args)
                store.close()
            finally:
                os.unlink(tmp)
        else:
            bad = _run_selfcheck(Container(pack(data)), y, path, args)
        failures += bad
    if failures:
        print(f"selfcheck FAILED ({failures} mismatching ranges)")
        return 1
    print(f"selfcheck passed on {args.backend}/{args.device}: every range "
          "matches the sequential host decode")
    return 0


def _run_selfcheck(store, y, path, args) -> int:
    nb = store.total_blocks(0)
    ranges = {(0, nb), (0, 1), (nb - 1, nb), (nb // 3, 2 * nb // 3 + 1)}
    ranges |= {(i, min(i + 7, nb)) for i in range(0, nb, max(nb // 5, 1))}
    ranges = sorted(r for r in ranges if 0 <= r[0] < r[1] <= nb)
    bad = _check_ranges(store, y, ranges, path, args)
    tag = "ok" if not bad else f"{bad} FAILED"
    print(f"{os.path.basename(path)}: blocks={nb} "
          f"ranges={len(ranges)} {tag}")
    return bad


def cmd_bigcheck(args) -> int:
    """Generate a >RAM-budget synthetic archive (size-capped via --mb) and
    verify it through a memory-mapped open.

    One modest session stream is encoded once (on the host) and appended
    under MANY channels until the file reaches the target size, so the
    archive can be arbitrarily large while each verification step (per
    channel) stays small -- the point is exercising
    ``Container.open(mmap=True)`` and the zero-copy chunk reads on a file
    that need never fit in memory at once.
    """
    from repro_torch.core import IdealemCodec
    from repro_torch.core.stream import decode_stream
    from repro_torch.store import Container, ContainerWriter, decode_channels
    codec = IdealemCodec(mode="std", block_size=32, num_dict=32, alpha=0.05,
                         rel_tol=0.5, backend="numpy", device=args.device)
    rng = np.random.default_rng(0)
    levels = rng.normal(0, 2, size=6)
    n = args.channel_blocks * 32
    # wandering level + drift: plenty of misses so each channel carries
    # real payload bytes (a near-all-hit stream would need tens of
    # thousands of channels to reach the size target)
    x = (rng.normal(0, 1, size=n)
         + levels[rng.integers(0, 6, size=args.channel_blocks).repeat(32)]
         + np.arange(n) * (4.0 / 32))
    sess = codec.session()
    feed = 64 * 32
    segs = [sess.feed(x[lo:lo + feed]) for lo in range(0, n, feed)]
    segs.append(sess.finish())
    stream = b"".join(segs)
    y = decode_stream(stream, backend="numpy")

    out = args.out
    if out is None:
        fd, out = tempfile.mkstemp(suffix=".idlmc")
        os.close(fd)
        cleanup = True
    else:
        cleanup = False
    try:
        target = int(args.mb * 1e6)
        w = ContainerWriter(out)
        ch = 0
        while ch == 0 or ch * len(stream) < target:
            w.append(stream, channel=ch)
            ch += 1
        w.finalize()
        size = os.path.getsize(out)
        store = Container.open(out, mmap=args.mmap)
        info = store.describe()
        print(f"bigcheck archive: {size / 1e6:.1f} MB, {ch} channels, "
              f"{info['chunks']} chunks, index={info['index_bytes']} B "
              f"({'mmap' if args.mmap else 'in-memory'})")
        if not isinstance(store.chunk_bytes(0), memoryview):
            print("FAIL: chunk reads are not zero-copy views")
            return 1
        nb = store.total_blocks(0)
        check = sorted({0, ch // 2, ch - 1})
        bad = 0
        for c in check:
            ranges = [(0, nb), (nb // 2, nb // 2 + 3), (nb - 1, nb)]
            ranges += [(int(i), min(int(i) + 5, nb))
                       for i in rng.integers(0, nb - 1, size=8)]
            bad += _check_ranges(store, y, ranges, out, args, channel=c)
            got = decode_channels(store, [c], backend=args.backend,
                                  device=args.device)[c]
            if not np.array_equal(got, y):  # y carries the tail already
                bad += 1
                print(f"  MISMATCH full channel {c}")
        store.close()
        if bad:
            print(f"bigcheck FAILED ({bad} mismatches)")
            return 1
        print(f"bigcheck passed: {len(check)} channels verified via "
              f"{'mmap' if args.mmap else 'bytes'} on "
              f"{args.backend}/{args.device}")
        return 0
    finally:
        if cleanup and os.path.exists(out):
            os.unlink(out)


def _read_args(p) -> None:
    p.add_argument("--backend", default="cuda", choices=READ_BACKENDS,
                   help="reconstruction backend (repro_torch.core.decode)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the tensor backends run")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="store_tool",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("pack", help="wrap .idlm streams in a container")
    p.add_argument("out")
    p.add_argument("streams", nargs="+")
    p.set_defaults(fn=cmd_pack)

    p = sub.add_parser("inspect", help="print the container index summary")
    p.add_argument("container")
    p.add_argument("--chunks", action="store_true",
                   help="also dump the per-chunk index records")
    p.add_argument("--mmap", action="store_true",
                   help="open the container memory-mapped")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("extract", help="decode a channel/range")
    p.add_argument("container")
    p.add_argument("--channel", type=int, default=None)
    p.add_argument("--blocks", default=None, metavar="I:J",
                   help="block range (default: whole channel incl. tail)")
    p.add_argument("-o", "--output", default=None, help="write .npy here")
    p.add_argument("--mmap", action="store_true",
                   help="open the container memory-mapped")
    _read_args(p)
    p.set_defaults(fn=cmd_extract)

    p = sub.add_parser("selfcheck",
                       help="verify range-decode == full-decode slices")
    p.add_argument("streams", nargs="+")
    p.add_argument("--mmap", action="store_true",
                   help="round-trip through a mmap-backed file open")
    _read_args(p)
    p.set_defaults(fn=cmd_selfcheck)

    p = sub.add_parser("bigcheck",
                       help="generate + verify a large mmap-backed archive")
    p.add_argument("--mb", type=float, default=64.0,
                   help="approximate archive size in MB (CI caps this)")
    p.add_argument("--channel-blocks", type=int, default=2048,
                   help="blocks per synthetic channel")
    p.add_argument("--mmap", action=argparse.BooleanOptionalAction,
                   default=True, help="open the archive memory-mapped")
    p.add_argument("--out", default=None,
                   help="write the archive here (default: temp file)")
    _read_args(p)
    p.set_defaults(fn=cmd_bigcheck)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
