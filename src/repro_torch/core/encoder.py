"""The IDEALEM encoder: a FIFO-dictionary scan over blocks (paper Sec. III).

The reference C encoder walks the dictionary and early-exits at the first
KS pass.  Here every step computes the min/max gate (eq. 3) and the KS
distance against *all* D entries as dense masked tensor work and selects
the lowest passing entry -- decision-identical to the early-exit walk.
Channels are a leading batch axis of every tensor, so C independent streams
advance in lockstep.

``DictState`` is a resumable carry: ``encode_decisions(..., state=s)``
continues a scan where the last chunk stopped and returns the updated
state, so a stream encoded in chunks makes exactly the same decisions as
one scan over all of it.  :func:`state_from_numpy` / :func:`state_to_numpy`
carry a state across to and from the reference package's ``DictState``.

Matchers: ``None``/``"reference"`` is the plain tensor step below (a Python
loop over blocks); ``"fused"`` is the hand-written CUDA scan
(``repro_torch.kernels.encode_step``), which runs the whole feed in one
launch.  Both sort every block once before the scan (the sort is hoisted
out of the step) and honour the ``valid`` ragged-padding mask.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from .ks import ks_statistic_many

__all__ = ["DictState", "EncoderParams", "init_state", "state_from_numpy",
           "state_to_numpy", "matcher_reference", "encode_decisions",
           "encode_decisions_batched", "MATCHERS"]

MATCHERS = ("reference", "fused")

# "no entry passed" marker for the arg-min over dictionary rows; any real
# row index (< 256) is far below it.
SENTINEL = 2 ** 30


class DictState(NamedTuple):
    """Resumable carry of the encoder scan: the FIFO dictionary buffer.

    Batched states carry a leading ``(C,)`` axis on every field
    (``init_state(channels=C)``).
    """

    sorted_blocks: torch.Tensor  # (..., D, n) sorted source distributions
    dmin: torch.Tensor           # (..., D)
    dmax: torch.Tensor           # (..., D)
    valid: torch.Tensor          # (..., D) bool
    count: torch.Tensor          # (...) int32, inserts so far (FIFO position)


class EncoderParams(NamedTuple):
    d_crit: float       # critical KS distance (ks.critical_distance)
    rel_tol: float      # relative tolerance r of the min/max gate (eq. 3)
    use_minmax: bool    # paper's gate; False = "KS test only" ablation
    use_ks: bool = True  # False = min/max gate alone (ablation)


def init_state(num_dict: int, n: int, dtype=torch.float32,
               channels: Optional[int] = None,
               device=None) -> DictState:
    """Fresh (empty-dictionary) carry on ``device`` (default ``"cuda"``,
    which raises without a GPU); ``channels=C`` stacks C per-channel
    states."""
    lead = () if channels is None else (channels,)
    kw = dict(device=resolve_device(device))
    return DictState(
        sorted_blocks=torch.zeros(lead + (num_dict, n), dtype=dtype, **kw),
        dmin=torch.zeros(lead + (num_dict,), dtype=dtype, **kw),
        dmax=torch.zeros(lead + (num_dict,), dtype=dtype, **kw),
        valid=torch.zeros(lead + (num_dict,), dtype=torch.bool, **kw),
        count=torch.zeros(lead, dtype=torch.int32, **kw),
    )


def state_from_numpy(state, device=None) -> DictState:
    """The port's carry from a reference-package ``DictState`` whose fields
    were converted with ``np.asarray`` (any object with the five carry
    attributes works), so a stream started there resumes here.  Raises for
    an error-bounded carry (non-empty ``raw_blocks``), a mode this port
    does not have yet (ROADMAP Queue 1 item 5).  ``device`` defaults to
    ``"cuda"``, as :func:`init_state`'s does."""
    raw = getattr(state, "raw_blocks", None)
    if raw is not None and np.asarray(raw).shape[-2] != 0:
        raise ValueError("error-bounded carries (non-empty raw_blocks) are "
                         "not ported yet (ROADMAP Queue 1 item 5)")
    device = resolve_device(device)

    def t(a, dtype=None):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return DictState(
        sorted_blocks=t(state.sorted_blocks), dmin=t(state.dmin),
        dmax=t(state.dmax), valid=t(state.valid, torch.bool),
        count=t(state.count, torch.int32))


def state_to_numpy(state: DictState) -> dict:
    """The carry as numpy arrays keyed by the reference ``DictState``
    fields, ``raw_blocks`` included as its empty ``(..., 0, n)`` form, so
    ``repro.core.encoder.DictState(**state_to_numpy(s))`` resumes there."""
    out = {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}
    sb = out["sorted_blocks"]
    out["raw_blocks"] = np.zeros(sb.shape[:-2] + (0, sb.shape[-1]), sb.dtype)
    return out


def _minmax_gate(xmin, xmax, dmin, dmax, r):
    """Eq. (3): both block extremes inside +-w*r of the stored extremes.
    ``r`` is a tensor of the carry's dtype, so each product and difference
    rounds in that dtype."""
    w = dmax - dmin
    t = w * r
    return ((xmin >= dmin - t) & (xmin <= dmin + t)
            & (xmax >= dmax - t) & (xmax <= dmax + t))


def matcher_reference(xs_sorted, dict_sorted, dmin, dmax, rel_tol):
    """Plain matcher: ``(ks (..., D), mm (..., D))`` of sorted candidates
    ``(..., n)`` against every dictionary row ``(..., D, n)``."""
    ks = ks_statistic_many(xs_sorted, dict_sorted)
    r = torch.tensor(rel_tol, dtype=dmin.dtype, device=dmin.device)
    mm = _minmax_gate(xs_sorted[..., :1], xs_sorted[..., -1:], dmin, dmax, r)
    return ks, mm


def _decide(state: DictState, xs, ok, valid):
    """Second half of a step, shared by the reference and fused plain
    steps: the lowest passing row (``ok`` (C, D)) or the FIFO insert of the
    sorted candidates ``xs`` (C, n) at ``count % D``.  A False ``valid``
    (C,) step leaves its channel's carry untouched and decides all-zero."""
    num_dict = state.sorted_blocks.shape[-2]
    ids = torch.arange(num_dict, dtype=torch.int32, device=xs.device)
    best = torch.where(ok, ids, SENTINEL).amin(-1)
    is_hit = (best < SENTINEL) & valid
    ins = torch.remainder(state.count, num_dict)
    do_ins = ~is_hit & valid
    overwrite = do_ins & (state.count >= num_dict)
    slot = torch.where(is_hit, best, ins)
    slot = torch.where(valid, slot, 0).to(torch.int32)
    upd = (ids == ins[:, None]) & do_ins[:, None]          # (C, D)
    new_state = DictState(
        sorted_blocks=torch.where(upd[..., None], xs[:, None, :],
                                  state.sorted_blocks),
        dmin=torch.where(upd, xs[:, :1], state.dmin),
        dmax=torch.where(upd, xs[:, -1:], state.dmax),
        valid=state.valid | upd,
        count=state.count + do_ins.to(torch.int32),
    )
    return new_state, (is_hit, slot, overwrite)


def _step(params: EncoderParams, state: DictState, xs, valid):
    """One reference step for C channels: sorted candidates ``xs`` (C, n),
    ragged-padding mask ``valid`` (C,)."""
    ks, mm = matcher_reference(xs, state.sorted_blocks, state.dmin,
                               state.dmax, params.rel_tol)
    ok = state.valid
    if params.use_minmax:
        ok = ok & mm
    if params.use_ks:
        ok = ok & (ks <= torch.tensor(params.d_crit, dtype=torch.float32,
                                      device=ks.device))
    return _decide(state, xs, ok, valid)


def _resolve_matcher(matcher) -> str:
    if matcher is None:
        return "reference"
    if matcher in MATCHERS:
        return matcher
    if matcher == "ops":
        raise ValueError("matcher='ops' waits for the port of the dict_match "
                         "kernel (ROADMAP Queue 2, K3)")
    if matcher == "auto":
        raise ValueError("matcher='auto' waits for the port of the measured "
                         "tuner (ROADMAP Queue 1 item 4)")
    raise ValueError(f"unknown matcher {matcher!r}; expected None or one of "
                     f"{MATCHERS}")


def encode_decisions_batched(
    blocks_cn: torch.Tensor,
    *,
    num_dict: int,
    d_crit: float,
    rel_tol: float = 0.1,
    use_minmax: bool = True,
    use_ks: bool = True,
    matcher: Optional[str] = None,
    state: Optional[DictState] = None,
    valid: Optional[torch.Tensor] = None,
):
    """Encode C channels of (already transformed) blocks ``(C, nb, n)``.

    One-shot (``state=None``) returns the ``(C, nb)`` decision triple
    ``(is_hit, slot, overwrite)``; resumable (``state=init_state(...,
    channels=C)`` or a previous return) returns ``((is_hit, slot,
    overwrite), new_state)``.  ``valid`` (C, nb) masks padded blocks of
    ragged channels.  The input state is not modified.
    """
    m = _resolve_matcher(matcher)
    C, nb, n = blocks_cn.shape
    dev = blocks_cn.device
    return_state = state is not None
    if state is None:
        state = init_state(num_dict, n, dtype=blocks_cn.dtype, channels=C,
                           device=dev)
    if valid is None:
        valid = torch.ones((C, nb), dtype=torch.bool, device=dev)
    xs_all = torch.sort(blocks_cn, dim=-1).values  # hoisted out of the step
    if m == "fused":
        from ..kernels.encode_step import encode_scan
        out, state = encode_scan(xs_all, valid, state, d_crit=d_crit,
                                 rel_tol=rel_tol, use_minmax=use_minmax,
                                 use_ks=use_ks)
    else:
        params = EncoderParams(float(d_crit), float(rel_tol),
                               bool(use_minmax), bool(use_ks))
        hs, ss, os_ = [], [], []
        for b in range(nb):
            state, (h, s, o) = _step(params, state, xs_all[:, b],
                                     valid[:, b])
            hs.append(h)
            ss.append(s)
            os_.append(o)
        if nb:
            out = tuple(torch.stack(v, dim=1) for v in (hs, ss, os_))
        else:
            out = (torch.zeros((C, 0), dtype=torch.bool, device=dev),
                   torch.zeros((C, 0), dtype=torch.int32, device=dev),
                   torch.zeros((C, 0), dtype=torch.bool, device=dev))
    return (out, state) if return_state else out


def encode_decisions(blocks: torch.Tensor, *, num_dict: int,
                     state: Optional[DictState] = None,
                     valid: Optional[torch.Tensor] = None, **kw):
    """Single-channel :func:`encode_decisions_batched`: blocks ``(nb, n)``,
    an unbatched ``state`` and ``valid`` (nb,); same return forms."""
    st = None if state is None else DictState(*(f[None] for f in state))
    out = encode_decisions_batched(
        blocks[None], num_dict=num_dict, state=st,
        valid=None if valid is None else valid[None], **kw)
    if state is None:
        return tuple(v[0] for v in out)
    (h, s, o), new = out
    return (h[0], s[0], o[0]), DictState(*(f[0] for f in new))
