"""Streaming telemetry pipeline on the card: a fleet of sensor channels
compressed *online* with IDEALEM (the paper's deployment scenario, Sec. I,
Fig. 15), the reference's ``examples/stream_compress.py`` on the PyTorch +
CUDA port.

Chunks arrive continuously; a batched session keeps one FIFO dictionary
per channel alive across chunks (one K1 launch a feed for the whole
fleet), so the hit rate matches offline one-shot compression.  For
contrast the naive approach (a one-shot encode per chunk, the dictionary
rebuilt every time) shows the hit rate it throws away.  ``--device cpu``
runs the plain PyTorch scan instead of the kernels.

  PYTHONPATH=src python examples_torch/stream_compress.py --channels 16
"""
import argparse
import time

import numpy as np

from repro_torch.core import IdealemCodec, decode_stream
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.serve import CompressionService


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--samples", type=int, default=32 * 512)
    ap.add_argument("--block", type=int, default=32)
    ap.add_argument("--chunk", type=int, default=1024,
                    help="samples per channel per feed() call")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    # the hand-written kernels on the card, the plain torch scan on the host
    backend = "cuda" if dev.type == "cuda" else "torch"
    on = dict(backend=backend, decode_backend=backend, device=str(dev))

    B = args.block
    chans = np.stack([
        synthetic.pmu_magnitude(args.samples, level=100 + 5 * i, noise=1.0,
                                seed=i) for i in range(args.channels)
    ])
    codec = IdealemCodec(mode="std", block_size=B, num_dict=255, alpha=0.01,
                         rel_tol=0.5, **on)

    # --- streaming path: chunked feed through a batched session ---
    svc = CompressionService(mode="std", block_size=B, num_dict=255,
                             alpha=0.01, rel_tol=0.5, **on)
    svc.open_stream("pmu-fleet", channels=args.channels)
    segments = [[] for _ in range(args.channels)]
    t0 = time.time()
    for lo in range(0, args.samples, args.chunk):
        segs = svc.feed("pmu-fleet", chans[:, lo:lo + args.chunk])
        for ci, s in enumerate(segs):
            segments[ci].append(s)
    final = svc.close_stream("pmu-fleet")
    dt = time.time() - t0
    for ci, s in enumerate(final):
        segments[ci].append(s)
    stats = svc.stats("pmu-fleet")["channels"]
    rate = args.channels * args.samples / dt / 1e6
    hit_rate = sum(s["hits"] for s in stats) / sum(s["blocks"] for s in stats)
    ratio = (sum(s["bytes_in"] for s in stats)
             / sum(s["bytes_out"] for s in stats))
    print(f"session (chunk={args.chunk}): {args.channels} ch x "
          f"{args.samples} samples in {dt:.2f}s ({rate:.1f} Msamples/s), "
          f"hit rate {hit_rate:.2%}, ratio {ratio:.1f}")

    # --- naive chunked path: one-shot encode per chunk (state discarded) ---
    naive_hits = naive_blocks = naive_bytes = 0
    for ci in range(min(args.channels, 4)):
        for lo in range(0, args.samples, args.chunk):
            st = codec.encode_stats(chans[ci, lo:lo + args.chunk])
            naive_hits += st["hits"]
            naive_blocks += st["blocks"]
            naive_bytes += st["bytes"]
    naive_in = min(args.channels, 4) * args.samples * chans.itemsize
    print(f"naive per-chunk one-shot: hit rate "
          f"{naive_hits / max(naive_blocks, 1):.2%}, ratio "
          f"{naive_in / max(naive_bytes, 1):.1f} "
          f"(dictionary rebuilt every chunk)")

    # --- verification: chunked output decodes exactly like one-shot ---
    for ci in range(min(args.channels, 4)):
        blob = b"".join(segments[ci])
        y = decode_stream(blob, seed=codec.decode_seed, backend=backend,
                          device=dev)
        y_ref = codec.decode(codec.encode(chans[ci]))
        if len(y) != args.samples or not np.array_equal(y, y_ref):
            raise SystemExit(f"channel {ci} decode mismatch")
    print("chunked segments decode identically to one-shot encode "
          f"(verified on {min(args.channels, 4)} channels)")


if __name__ == "__main__":
    main()
