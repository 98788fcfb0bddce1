"""Sharded-encode byte-identity self-check.

The acceptance gate of the scale-out encode path, case for case the
reference package's ``repro.launch.shard_check``: for every mode x D
regime in ``CASES``

  * a channel-sharded session's segment bytes equal the session's without
    a plan;
  * a dictionary-sharded session's bytes equal them too;
  * ragged streams through a planned ``StreamCoalescer`` decode as a
    one-shot encode of each stream does.

Shards are devices listed in a plan, one process driving all of them:

  PYTHONPATH=src python -m repro_torch.launch.shard_check --devices 4 \\
      --device cpu --backend torch
  PYTHONPATH=src python -m repro_torch.launch.shard_check --devices 4

The second form puts the 4 shards on the CUDA cards round robin (all on
one card where there is one).  Prints one JSON record, the reference's;
``"status": "ok"`` means every case was byte-identical, and the exit code
is 1 otherwise.
"""
from __future__ import annotations

import json
from typing import List

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["CASES", "run_check", "shard_devices"]

CASES = [  # (mode, num_dict, value_range)
    ("std", 255, None),
    ("std", 1, None),
    ("residual", 32, (0.0, 360.0)),
    ("residual", 1, None),
    ("delta", 32, None),
    ("delta", 1, (0.0, 360.0)),
]


def shard_devices(count: int, device_type: str = "cuda"):
    """``count`` shard devices of ``device_type``: the host ``count``
    times, or the visible cards round robin (raising without one)."""
    if device_type == "cpu":
        return [torch.device("cpu")] * count
    resolve_device(device_type)
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(count)]


def _signal(n: int, vr, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    parts = [rng.normal(m, s, size=n // 3)
             for m, s in [(0, 1), (5, 0.5), (0, 1)]]
    x = np.concatenate(parts + [rng.normal(0, 1, size=n - 3 * (n // 3))])
    if vr is not None:
        x = np.mod(np.abs(x) * 40.0, vr[1] - vr[0]) + vr[0]
    return x


def _session_blobs(codec, chans, plan) -> List[bytes]:
    C = chans.shape[0]
    s = codec.session(channels=C, plan=plan)
    parts = [s.feed(chans[:, :517]), s.feed(chans[:, 517:]), s.finish()]
    return [b"".join(p[ci] for p in parts) for ci in range(C)]


def run_check(backend: str = "cuda", channels: int = 5,
              samples: int = 16 * 80 + 7, dict_shards: int = 0,
              devices=None) -> dict:
    """The three identities on every case, with shards on ``devices``
    (default: 2 shards on the cards).  ``dict_shards=0`` splits the
    dictionary over every shard for the D-axis case; ``1`` skips it."""
    from ..core import IdealemCodec
    from ..serve import FlushPolicy, StreamCoalescer
    from .encode_plan import make_encode_plan

    devs = (shard_devices(2) if devices is None
            else [resolve_device(d) for d in devices])
    n_dev = len(devs)
    if dict_shards == 0:
        dict_shards = n_dev
    checked = []
    for mode, num_dict, vr in CASES:
        codec = IdealemCodec(mode=mode, block_size=16, num_dict=num_dict,
                             alpha=0.05, rel_tol=0.5, value_range=vr,
                             backend=backend, device=devs[0])
        chans = np.stack([_signal(samples, vr, seed=11 + ci)
                          for ci in range(channels)])
        plan = make_encode_plan(channels, block_size=16, devices=devs)
        if plan.num_devices != min(n_dev, channels):
            raise AssertionError(f"plan {plan.summary()} for {n_dev} devices")

        # sharded session bytes == unsharded session bytes
        single = _session_blobs(codec, chans, plan=None)
        sharded = _session_blobs(codec, chans, plan=plan)
        if single != sharded:
            return {"status": "mismatch", "where": "session",
                    "mode": mode, "num_dict": num_dict}

        # D-sharded session bytes == unsharded session bytes: every
        # channel's dictionary rows split over the shards, each step's best
        # match reduced across them
        if dict_shards > 1:
            dplan = make_encode_plan(channels, block_size=16, devices=devs,
                                     dict_shards=dict_shards)
            if dplan.dict_shards != dict_shards:
                raise AssertionError(f"plan {dplan.summary()}")
            dsharded = _session_blobs(codec, chans, plan=dplan)
            if single != dsharded:
                return {"status": "mismatch", "where": "session_dshard",
                        "mode": mode, "num_dict": num_dict}

        # coalesced ragged streams decode like a one-shot per-stream encode
        cplan = make_encode_plan(-(-channels // n_dev) * n_dev,
                                 block_size=16, devices=devs)
        co = StreamCoalescer(policy=FlushPolicy(max_batch_blocks=64),
                             plan=cplan, mode=mode, block_size=16,
                             num_dict=num_dict, alpha=0.05, rel_tol=0.5,
                             value_range=vr, backend=backend, device=devs[0])
        segs = {ci: [] for ci in range(channels)}
        for ci in range(channels):
            co.open_stream(str(ci))
        step = [37 + 13 * ci for ci in range(channels)]
        lo = [0] * channels
        while any(lo[ci] < samples for ci in range(channels)):
            for ci in range(channels):
                if lo[ci] < samples:
                    res = co.submit(str(ci),
                                    chans[ci, lo[ci]:lo[ci] + step[ci]])
                    lo[ci] += step[ci]
                    if res:
                        for k, v in res.items():
                            segs[int(k)].append(v)
        for ci in range(channels):
            segs[ci].append(co.close_stream(str(ci)))
        for ci in range(channels):
            got = codec.decode(b"".join(segs[ci]))
            ref = codec.decode(codec.encode(chans[ci]))
            if not np.array_equal(got, ref):
                return {"status": "mismatch", "where": "coalescer",
                        "mode": mode, "num_dict": num_dict, "channel": ci}
        checked.append(f"{mode}/D{num_dict}")
    return {"status": "ok", "devices": n_dev, "backend": backend,
            "cases": checked}


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=2,
                    help="shards to place (default 2)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device type of the shards (default cuda: the "
                         "cards round robin)")
    ap.add_argument("--backend", default="cuda", choices=["torch", "cuda"])
    ap.add_argument("--dict-shards", type=int, default=0,
                    help="dictionary shards for the D-axis case "
                         "(0 = all shards, 1 = skip)")
    args = ap.parse_args()
    rec = run_check(backend=args.backend, dict_shards=args.dict_shards,
                    devices=shard_devices(args.devices, args.device))
    print(json.dumps(rec))
    if rec["status"] != "ok":
        raise SystemExit(1)


if __name__ == "__main__":
    main()
