"""Serving launcher: batched decode with the port's ServeEngine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
      --batch 8 --prompt-len 256 --gen 64 --max-seq 2048

runs on the card (``--device cuda``, the default) with weights drawn from a
seeded ``torch.Generator``; ``--smoke --device cpu`` runs the reduced
configuration on the host.  ``--arch`` takes every ported architecture
(default rwkv6-3b, the reference launcher's); the vlm and audio families
get cross caches of ``num_image_tokens`` / ``encoder_seq`` positions.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import ALIASES, get_config
from ..device import resolve_device
from ..models import lm
from ..serve import ServeEngine


def memory_len(cfg) -> int:
    """The cross caches' length, as the reference's launcher derives it."""
    return (cfg.num_image_tokens if cfg.family == "vlm"
            else cfg.encoder_seq if cfg.family == "audio" else 0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b",
                    choices=sorted(ALIASES))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm.init_params(cfg, gen, dev)
    engine = ServeEngine(cfg, params, max_seq=args.max_seq,
                         memory_len=memory_len(cfg),
                         temperature=args.temperature, device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(args.batch, args.prompt_len)).astype(np.int32)
    out = engine.generate(prompts, args.gen, seed=args.seed)
    st = engine.stats
    print(f"arch={cfg.name} device={dev} generated {out.shape}: prefill "
          f"{st['prefill_tokens'] / st['prefill_s']:.1f} tok/s, decode "
          f"{st['generated_tokens'] / st['decode_s']:.1f} tok/s "
          f"({st['prefill_s'] + st['decode_s']:.2f} s)")
    print("sample:", out[0][:16].tolist())


if __name__ == "__main__":
    main()
