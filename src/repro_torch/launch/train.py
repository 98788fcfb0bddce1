"""Training launcher: the fault-tolerant trainer over synthetic token
batches, on the card or the host.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --steps 20 --gradcomp --inject-crash 7

runs on the card (``--device cuda``, the default) with float32 master
weights drawn from a ``torch.Generator`` seeded with 0; ``--smoke
--device cpu`` runs the reduced configuration on the host.  The flags
and defaults are the reference launcher's (``repro/launch/train.py``),
with ``--device`` added; checkpoints go to ``--ckpt-dir`` (default a
directory under the system's temporary directory).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..configs import ALIASES, get_config
from ..data import synthetic
from ..device import resolve_device
from ..runtime import FaultInjector, FaultTolerantTrainer
from ..train import init_train_state, make_train_step


def build_batches(cfg, steps: int, batch: int, seq: int, seed: int = 0):
    """``steps`` batches of the reference's token stream (numpy), with zero
    image embeddings (vlm) or frames (audio) where the family reads
    them."""
    batches = list(synthetic.token_stream(steps, batch, seq, cfg.vocab_size,
                                          seed=seed))
    for b in batches:
        if cfg.family == "vlm":
            b["memory"] = np.zeros((batch, cfg.num_image_tokens, cfg.d_model),
                                   np.float32)
        if cfg.family == "audio":
            b["frames"] = np.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                   np.float32)
    return batches


def main(argv=None) -> FaultTolerantTrainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-1b-a400m",
                    choices=sorted(ALIASES))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--gradcomp", action="store_true",
                    help="IDEALEM gradient compression + error feedback")
    ap.add_argument("--inject-crash", type=int, default=None,
                    help="simulate a node failure at this step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(ALIASES.get(args.arch, args.arch), smoke=args.smoke)
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"steps={args.steps} device={dev}")
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev, use_gradcomp=args.gradcomp)
    step_fn = make_train_step(cfg, lr=args.lr, microbatches=args.microbatches,
                              use_gradcomp=args.gradcomp)
    injector = FaultInjector({args.inject_crash: "crash"}) \
        if args.inject_crash is not None else None
    trainer = FaultTolerantTrainer(
        train_step=step_fn, state=state, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, injector=injector)
    batches = build_batches(cfg, args.steps, args.batch, args.seq)
    t0 = time.time()
    trainer.run(batches, args.steps)
    dt = time.time() - t0
    losses = [e["loss"] for e in trainer.log if "loss" in e]
    print(f"done: {args.steps} steps in {dt:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"events: {[e for e in trainer.log if 'event' in e]}")
    return trainer


if __name__ == "__main__":
    main()
