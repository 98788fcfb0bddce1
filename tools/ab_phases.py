"""Run chip_smoke.py's [serve] and [families] phases of another checkout
on the card, its kernels built from that checkout's sources.  Two trees'
decode steps are compared by running this for each, alternated, on one
card in one go:

    python3 tools/ab_phases.py <checkout>

Each phase prints its JSON line (``decode_step_ms``,
``device_ops_per_step``, ...) as ``chip_smoke.py`` does.
"""
import sys

import torch

root = sys.argv[1]
sys.path.insert(0, root)
import chip_smoke as cs  # noqa: E402

sys.path.insert(0, root + "/src")
sys.path.insert(0, root + "/tests")
dev = torch.device("cuda")
card = cs.card_line()
cs.say(f"[ab] {root}; torch {torch.__version__}; {card}")
cs.phase_build()
cs.phase_serve(torch, dev, card)
cs.phase_families(torch, dev, card)
cs.say("[ab] done")
