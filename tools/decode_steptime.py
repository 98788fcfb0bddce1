"""Host ms a decode step of a checkout on the card: ``lm.decode_step``
with K4, B=8, greedy, at published widths, for gemma3-27b (62 layers)
and granite-3-8b (40 layers).  Each model runs 4 rounds of 24 steps; the
first warms up, the other three are printed.  Two trees are compared by
running this for each in alternation (parent, change, change, parent,
...) on one card in one go:

    python3 tools/decode_steptime.py <checkout> <label>

The last line is ``STEP {"tree": label, arch: [ms, ms, ms], ...}``.
"""
import json
import sys
import time

import numpy as np
import torch

sys.path.insert(0, sys.argv[1] + "/src")
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402

ROUNDS, STEPS, BATCH, MAX_SEQ = 4, 24, 8, 512

dev = torch.device("cuda")
out = {"tree": sys.argv[2]}
for arch in ("gemma3-27b", "granite-3-8b"):
    cfg = get_config(arch)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    cache = lm.init_cache(cfg, BATCH, MAX_SEQ, device=dev)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (BATCH, 1))).to(dev)
    rounds = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            logits, cache = lm.decode_step(params, cache, tok, cfg,
                                           backend="cuda")
            tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0) / STEPS * 1e3)
    out[arch] = rounds[1:]
    del params, cache, logits
    torch.cuda.empty_cache()
print("STEP " + json.dumps(out), flush=True)
