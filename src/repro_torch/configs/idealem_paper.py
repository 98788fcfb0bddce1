"""The paper's own experiment configuration (Table I): IDEALEM parameters
for uPMU magnitude (standard mode) and phase angle (residual/delta mode),
the reference's ``repro/configs/idealem_paper.py`` over the port's codec."""
from ..core import IdealemCodec

__all__ = ["MAG", "ANG_RESIDUAL", "ANG_DELTA", "mag_codec", "ang_codec"]

# MAG channels: standard mode, B=32, D=255, alpha=0.01 (Sec. VII-A)
MAG = dict(mode="std", block_size=32, num_dict=255, alpha=0.01, rel_tol=0.5)

# ANG channels: residual mode, B=112, D=255, alpha=0.01, range [0, 360)
ANG_RESIDUAL = dict(mode="residual", block_size=112, num_dict=255, alpha=0.01,
                    rel_tol=0.5, value_range=(0.0, 360.0))
ANG_DELTA = dict(mode="delta", block_size=112, num_dict=255, alpha=0.01,
                 rel_tol=0.5, value_range=(0.0, 360.0))


def mag_codec(**kw) -> IdealemCodec:
    """A MAG codec; ``kw`` overrides (``device``, ``backend``, ...)."""
    return IdealemCodec(**{**MAG, **kw})


def ang_codec(delta: bool = False, **kw) -> IdealemCodec:
    """An ANG codec in residual (or, with ``delta``, delta) mode."""
    base = ANG_DELTA if delta else ANG_RESIDUAL
    return IdealemCodec(**{**base, **kw})
