"""End-to-end training on the card: LM training with fault
tolerance, checkpoint compression and IDEALEM gradient compression -- the
reference's ``examples/train_lm.py`` on the PyTorch + CUDA port.

A small model (the SMOKE config at 4 layers, d_model 128), float32 master
weights drawn from a ``torch.Generator`` seeded with 0.  ``--gradcomp``
compresses each step's gradient with IDEALEM on K1
(``csrc/encode_step.cu``); ``--inject-crash N`` simulates a node failure
at step N, restored from the last checkpoint.

  PYTHONPATH=src python examples_torch/train_lm.py --steps 200
  PYTHONPATH=src python examples_torch/train_lm.py --steps 50 --gradcomp \\
      --inject-crash 20
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import ALIASES, get_config
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.runtime import FaultInjector, FaultTolerantTrainer
from repro_torch.train import init_train_state, make_train_step

# The reference writes its checkpoints with zstd; the card's machine has
# no ``zstandard`` package, so the port's example compresses its float
# leaves with IDEALEM itself (``checkpoint/ckpt.py``).
CKPT_CODEC = "idealem"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-1b-a400m",
                    choices=sorted(ALIASES))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--gradcomp", action="store_true")
    ap.add_argument("--inject-crash", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a fresh temporary directory, removed "
                         "at the end (a directory that holds another "
                         "run's checkpoints would be resumed from)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = get_config(ALIASES.get(args.arch, args.arch), smoke=True).replace(
        num_layers=4, d_model=128, d_ff=256, vocab_size=512)
    print(f"training {cfg.name}-smoke ({cfg.param_count() / 1e6:.2f}M "
          f"params) for {args.steps} steps on {dev}")
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev, use_gradcomp=args.gradcomp)
    step = make_train_step(cfg, lr=3e-3, microbatches=2,
                           use_gradcomp=args.gradcomp)
    injector = (FaultInjector({args.inject_crash: "crash"})
                if args.inject_crash is not None else None)
    batches = list(synthetic.token_stream(args.steps, args.batch, args.seq,
                                          cfg.vocab_size))
    with tempfile.TemporaryDirectory() as tmp:
        trainer = FaultTolerantTrainer(
            train_step=step, state=state, ckpt_dir=args.ckpt_dir or tmp,
            ckpt_every=25, ckpt_codec=CKPT_CODEC, injector=injector)
        t0 = time.time()
        trainer.run(batches, args.steps)
        dt = time.time() - t0

    losses = [e["loss"] for e in trainer.log if "loss" in e]
    events = [e for e in trainer.log if "event" in e]
    toks = args.steps * args.batch * args.seq
    print(f"loss: {losses[0]:.3f} -> {np.mean(losses[-10:]):.3f} "
          f"({toks / dt:.0f} tok/s)")
    if events:
        print("fault-tolerance events:", events)
    if not np.mean(losses[-10:]) < losses[0]:
        raise SystemExit("training must reduce loss")
    print("OK")


if __name__ == "__main__":
    main()
