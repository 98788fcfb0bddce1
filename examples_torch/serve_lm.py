"""Batched serving demo on the card: prefill + decode across heterogeneous
architectures (attention KV caches, Mamba2 states, RWKV states behind one
cache API) -- the reference's ``examples/serve_lm.py`` on the PyTorch +
CUDA port.  An attention family's decode runs K4
(``csrc/flash_decode.cu``) once a self-attention layer and step.

Weights are drawn from a seeded ``torch.Generator`` (the reduced SMOKE
configs); tokens are sampled at ``--temperature`` from a generator seeded
by ``--seed``.

  PYTHONPATH=src python examples_torch/serve_lm.py --arch rwkv6-3b --gen 48
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ALIASES, get_config
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve import ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b", choices=sorted(ALIASES))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=True)
    params = lm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    mem_len = (cfg.num_image_tokens if cfg.family == "vlm"
               else cfg.encoder_seq if cfg.family == "audio" else 0)
    engine = ServeEngine(cfg, params, max_seq=args.prompt_len + args.gen + 8,
                         memory_len=mem_len, temperature=args.temperature,
                         device=dev)

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    t0 = time.time()
    out = engine.generate(prompts, args.gen, seed=args.seed)
    dt = time.time() - t0
    print(f"{cfg.name}-smoke: {args.batch}x{args.gen} tokens in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s) on {dev}")
    for i in range(min(2, args.batch)):
        print(f"  request {i}: {out[i][:12].tolist()} ...")
    ok = out.shape == (args.batch, args.gen) and bool(
        ((out >= 0) & (out < cfg.vocab_size)).all())
    print(f"tokens {tuple(out.shape)} in [0, {cfg.vocab_size}): {ok}")
    if not ok:
        raise SystemExit("tokens outside the vocabulary or of the wrong "
                         "shape")


if __name__ == "__main__":
    main()
