from . import adamw, gradcomp
from .adamw import AdamWState, global_norm, warmup_cosine

__all__ = ["adamw", "gradcomp", "AdamWState", "global_norm", "warmup_cosine"]
