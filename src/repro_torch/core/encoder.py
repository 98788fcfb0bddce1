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
loop over blocks); ``"ops"`` is the same loop with the matching done by the
hand-written CUDA kernel K3 (``repro_torch.kernels.ops.dict_match``, one
launch per block step for all channels); ``"fused"`` is the hand-written
CUDA scan K1 (``repro_torch.kernels.encode_step``), which runs the whole
feed in one launch; ``"auto"`` is the measured pick per (D, n, dtype,
device), persisted under ``REPRO_TORCH_ENCODE_AUTOTUNE``
(:func:`resolve_matcher`).  All sort every block once before the scan (the
sort is hoisted out of the step) and honour the ``valid`` ragged-padding
mask.

Error-bounded mode: with ``error_bound`` set, a would-be hit whose stored
raw (stream-order) row differs from the block by more than the bound at
some sample -- or, with ``error_cumulative`` (delta mode), whose running
sum of differences does -- is demoted to a miss.  The carry then holds the
raw rows too (``init_state(raw=True)``).
"""
from __future__ import annotations

import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.ref import error_gate, minmax_gate
from .ks import ks_statistic_many, ks_statistic_many_masked
from .tuning import MeasuredTuner, best_of

__all__ = ["DictState", "EncoderParams", "ChanParams", "init_state",
           "state_from_numpy", "state_to_numpy", "matcher_reference",
           "resolve_matcher", "encode_decisions", "encode_decisions_batched",
           "encode_decisions_mixed", "chan_params", "repad_state_n",
           "MATCHERS",
           "load_encode_autotune", "save_encode_autotune",
           "reset_encode_autotune", "encode_autotune_choices",
           "encode_autotune_cached"]

logger = logging.getLogger("repro_torch.core.encoder")

MATCHERS = ("reference", "ops", "fused")

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
    # (..., D, n) raw (stream-order) rows for the error-bounded mode's
    # pointwise check; (..., 0, n) when the mode is off
    raw_blocks: torch.Tensor


class EncoderParams(NamedTuple):
    d_crit: float       # critical KS distance (ks.critical_distance)
    rel_tol: float      # relative tolerance r of the min/max gate (eq. 3)
    use_minmax: bool    # paper's gate; False = "KS test only" ablation
    use_ks: bool = True  # False = min/max gate alone (ablation)
    # error-bounded mode: None disables it; error_cumulative bounds the
    # running sum of the payload difference (delta mode)
    error_bound: Optional[float] = None
    error_cumulative: bool = False


def init_state(num_dict: int, n: int, dtype=torch.float32,
               channels: Optional[int] = None, device=None,
               raw: bool = False) -> DictState:
    """Fresh (empty-dictionary) carry on ``device`` (default ``"cuda"``,
    which raises without a GPU); ``channels=C`` stacks C per-channel
    states.  ``raw`` allocates the raw rows the error-bounded mode matches
    against (required whenever ``error_bound`` is set)."""
    lead = () if channels is None else (channels,)
    kw = dict(device=resolve_device(device))
    return DictState(
        sorted_blocks=torch.zeros(lead + (num_dict, n), dtype=dtype, **kw),
        dmin=torch.zeros(lead + (num_dict,), dtype=dtype, **kw),
        dmax=torch.zeros(lead + (num_dict,), dtype=dtype, **kw),
        valid=torch.zeros(lead + (num_dict,), dtype=torch.bool, **kw),
        count=torch.zeros(lead, dtype=torch.int32, **kw),
        raw_blocks=torch.zeros(lead + (num_dict if raw else 0, n),
                               dtype=dtype, **kw),
    )


def state_from_numpy(state, device=None) -> DictState:
    """The port's carry from a reference-package ``DictState`` whose fields
    were converted with ``np.asarray`` (any object with the carry's
    attributes works; a missing ``raw_blocks`` means the mode is off), so a
    stream started there resumes here.  Raises ``ValueError`` for raw rows
    that match neither the empty ``(..., 0, n)`` form nor the dictionary's
    shape.  ``device`` defaults to ``"cuda"``, as :func:`init_state`'s
    does."""
    device = resolve_device(device)

    def t(a, dtype=None):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    sb = t(state.sorted_blocks)
    raw = getattr(state, "raw_blocks", None)
    raw = (torch.zeros(sb.shape[:-2] + (0, sb.shape[-1]), dtype=sb.dtype,
                       device=device) if raw is None else t(raw))
    if raw.shape[-2] != 0 and raw.shape != sb.shape:
        raise ValueError(f"raw_blocks {tuple(raw.shape)} must be empty or "
                         f"match sorted_blocks {tuple(sb.shape)}")
    return DictState(
        sorted_blocks=sb, dmin=t(state.dmin), dmax=t(state.dmax),
        valid=t(state.valid, torch.bool), count=t(state.count, torch.int32),
        raw_blocks=raw)


def state_to_numpy(state: DictState) -> dict:
    """The carry as numpy arrays keyed by the reference ``DictState``
    fields, so ``repro.core.encoder.DictState(**state_to_numpy(s))``
    resumes there."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def matcher_reference(xs_sorted, dict_sorted, dmin, dmax, rel_tol):
    """Plain matcher: ``(ks (..., D), mm (..., D))`` of sorted candidates
    ``(..., n)`` against every dictionary row ``(..., D, n)``."""
    ks = ks_statistic_many(xs_sorted, dict_sorted)
    r = torch.tensor(rel_tol, dtype=dmin.dtype)
    mm = minmax_gate(xs_sorted[..., :1], xs_sorted[..., -1:], dmin, dmax, r)
    return ks, mm


def _decide(state: DictState, xs, ok, valid, raw=None, xmax=None):
    """Second half of a step, shared by every plain step: the lowest
    passing row (``ok`` (C, D)) or the FIFO insert of the sorted candidates
    ``xs`` (C, n) -- and, in the error-bounded mode, of their raw rows
    ``raw`` (C, n) -- at ``count % D``.  A False ``valid`` (C,) step leaves
    its channel's carry untouched and decides all-zero.  The stored
    maximum is ``xmax`` (C, 1) where given (the mixed-mode scan's masked
    maximum), else each candidate's last point."""
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
    raw_blocks = state.raw_blocks
    if raw is not None:
        raw_blocks = torch.where(upd[..., None], raw[:, None, :], raw_blocks)
    new_state = DictState(
        sorted_blocks=torch.where(upd[..., None], xs[:, None, :],
                                  state.sorted_blocks),
        dmin=torch.where(upd, xs[:, :1], state.dmin),
        dmax=torch.where(upd, xs[:, -1:] if xmax is None else xmax,
                         state.dmax),
        valid=state.valid | upd,
        count=state.count + do_ins.to(torch.int32),
        raw_blocks=raw_blocks,
    )
    return new_state, (is_hit, slot, overwrite)


def _step(matcher: str, params: EncoderParams, state: DictState, xs, valid,
          raw):
    """One step for C channels: sorted candidates ``xs`` (C, n), their raw
    rows ``raw`` (C, n), ragged-padding mask ``valid`` (C,).  ``matcher``
    is ``"reference"`` (plain tensor matching) or ``"ops"`` (K3)."""
    if matcher == "ops":
        from ..kernels import ops
        ks, mm = ops.dict_match(xs, state.sorted_blocks, state.dmin,
                                state.dmax, params.rel_tol)
    else:
        ks, mm = matcher_reference(xs, state.sorted_blocks, state.dmin,
                                   state.dmax, params.rel_tol)
    ok = state.valid
    if params.use_minmax:
        ok = ok & mm
    if params.use_ks:
        ok = ok & (ks <= torch.tensor(params.d_crit, dtype=torch.float32))
    if params.error_bound is None:
        return _decide(state, xs, ok, valid)
    ok = ok & error_gate(raw, state.raw_blocks, params.error_bound,
                         params.error_cumulative)
    return _decide(state, xs, ok, valid, raw)


# ------------------------------------------- measured matcher autotuning
#
# ``matcher="auto"``: the first use of a (D, n, dtype, device) combination
# times the reference, ops and fused scans on a probe, routes the
# combination to the fastest, and persists the choice under
# ``REPRO_TORCH_ENCODE_AUTOTUNE`` (the reference package's cache lives
# under another variable: the two never read each other's timings).

ENCODE_AUTOTUNE_VERSION = 1
_PROBE_BLOCKS = 8

_TUNER = MeasuredTuner(
    version=ENCODE_AUTOTUNE_VERSION, env_var="REPRO_TORCH_ENCODE_AUTOTUNE",
    validate_entry=lambda ent: ent.get("matcher") in MATCHERS, log=logger,
    name="encode")


def _matcher_key(num_dict: int, n: int, dtype, device) -> str:
    dt = str(dtype).replace("torch.", "")
    return (f"D={int(num_dict)}|n={int(n)}|dtype={dt}"
            f"|device={resolve_device(device).type}")


def load_encode_autotune(path: str, strict: bool = True) -> int:
    """Load persisted matcher choices (see ``core.tuning``); entry count."""
    return _TUNER.load(path, strict=strict)


def save_encode_autotune(path: str) -> None:
    """Persist the in-memory matcher choices (atomic replace)."""
    _TUNER.save(path)


def reset_encode_autotune() -> None:
    """Forget every matcher choice; the next ``"auto"`` re-probes."""
    _TUNER.reset()


def encode_autotune_choices() -> dict:
    """Current ``matcher="auto"`` routing table: key -> matcher name."""
    return _TUNER.choices("matcher")


def encode_autotune_cached(num_dict: int, n: int, dtype, device=None) -> bool:
    """Whether ``matcher="auto"`` for (D, n, dtype) on ``device`` (default
    ``"cuda"``) resolves from the table."""
    return _TUNER.cached(_matcher_key(num_dict, n, dtype, device))


def _probe_matcher(num_dict: int, n: int, dtype, device) -> dict:
    """Time each matcher on a short probe scan at the real (D, n, dtype)
    on ``device``.  A candidate that fails raises: a kernel that does not
    build or launch is never hidden behind another choice."""
    rng = np.random.default_rng(0)
    # mixture source: the dictionary fills, then hits and misses both occur
    blocks = torch.as_tensor(np.concatenate([
        rng.normal(m, s, size=(_PROBE_BLOCKS // 2, n))
        for m, s in [(0.0, 1.0), (5.0, 0.5)]]), dtype=dtype, device=device)
    kw = dict(num_dict=num_dict, d_crit=0.35, rel_tol=0.5)

    def run(m):
        encode_decisions(blocks, matcher=m, **kw)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    times = {m: best_of(lambda m=m: run(m)) for m in MATCHERS}
    winner = min(sorted(times), key=times.get)
    return {"matcher": winner, "tile_d": None,
            "times_us": {k: round(v * 1e6, 3) for k, v in times.items()}}


def resolve_matcher(matcher, *, num_dict: int, n: int, dtype,
                    device=None) -> str:
    """Concrete matcher name for an encode call.

    ``None`` -> ``"reference"``; names in :data:`MATCHERS` pass through;
    ``"auto"`` serves the measured choice for (D, n, dtype, device),
    probing (and persisting) on first use.  Anything else raises
    ``ValueError``."""
    if matcher is None:
        return "reference"
    if matcher in MATCHERS:
        return matcher
    if matcher == "auto":
        device = resolve_device(device)
        key = _matcher_key(num_dict, n, dtype, device)
        with _TUNER.lock:
            hit = _TUNER.cached(key)
            ent = _TUNER.resolve(key, lambda: _probe_matcher(
                int(num_dict), int(n), dtype, device))
            if not hit:
                logger.info("encode autotune: %s -> %s %s", key,
                            ent["matcher"], ent["times_us"])
        return ent["matcher"]
    raise ValueError(f"unknown matcher {matcher!r}; expected None or one of "
                     f"{MATCHERS + ('auto',)}")


def _empty_decisions(C: int, dev):
    return (torch.zeros((C, 0), dtype=torch.bool, device=dev),
            torch.zeros((C, 0), dtype=torch.int32, device=dev),
            torch.zeros((C, 0), dtype=torch.bool, device=dev))


def encode_decisions_batched(
    blocks_cn: torch.Tensor,
    *,
    num_dict: int,
    d_crit: float,
    rel_tol: float = 0.1,
    use_minmax: bool = True,
    use_ks: bool = True,
    error_bound: Optional[float] = None,
    error_cumulative: bool = False,
    matcher: Optional[str] = None,
    state: Optional[DictState] = None,
    valid: Optional[torch.Tensor] = None,
):
    """Encode C channels of (already transformed) blocks ``(C, nb, n)``.

    One-shot (``state=None``) returns the ``(C, nb)`` decision triple
    ``(is_hit, slot, overwrite)``; resumable (``state=init_state(...,
    channels=C)`` or a previous return) returns ``((is_hit, slot,
    overwrite), new_state)``.  ``valid`` (C, nb) masks padded blocks of
    ragged channels.  ``error_bound`` needs a carry with raw rows
    (``init_state(..., raw=True)``; a one-shot call makes one).  The input
    state is not modified.
    """
    C, nb, n = blocks_cn.shape
    dev = blocks_cn.device
    m = resolve_matcher(matcher, num_dict=num_dict, n=n,
                        dtype=blocks_cn.dtype, device=dev)
    return_state = state is not None
    if state is None:
        state = init_state(num_dict, n, dtype=blocks_cn.dtype, channels=C,
                           device=dev, raw=error_bound is not None)
    if error_bound is not None and state.raw_blocks.shape[-2] == 0:
        raise ValueError("error_bound requires a state created with "
                         "init_state(..., raw=True)")
    if valid is None:
        valid = torch.ones((C, nb), dtype=torch.bool, device=dev)
    xs_all = torch.sort(blocks_cn, dim=-1).values  # hoisted out of the step
    eb = dict(error_bound=None if error_bound is None else float(error_bound),
              error_cumulative=bool(error_cumulative))
    if m == "fused":
        from ..kernels.encode_step import encode_scan
        out, state = encode_scan(xs_all, valid, state, d_crit=d_crit,
                                 rel_tol=rel_tol, use_minmax=use_minmax,
                                 use_ks=use_ks, raw=blocks_cn, **eb)
    else:
        params = EncoderParams(float(d_crit), float(rel_tol),
                               bool(use_minmax), bool(use_ks), **eb)
        acc = ([], [], [])
        for b in range(nb):
            state, dec = _step(m, params, state, xs_all[:, b], valid[:, b],
                               blocks_cn[:, b])
            for a, v in zip(acc, dec):
                a.append(v)
        out = (tuple(torch.stack(a, dim=1) for a in acc) if nb
               else _empty_decisions(C, dev))
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


# ------------------------------------------- masked mixed-mode (adaptive)
#
# Adaptive sessions diverge per channel: payload width (std vs
# residual/delta), KS threshold (selector-scaled d_crit) and error metric
# (plain vs cumulative).  The mixed scan pads every payload to the cohort's
# widest with +inf, masks each channel's tail columns, and carries the
# formerly static parameters per channel (ChanParams): one dispatch per
# feed for the whole cohort, with the decisions and carry of the reference
# package's ``encode_decisions_mixed``.

class ChanParams(NamedTuple):
    """Per-channel parameters of the mixed-mode scan, (C,) tensors built
    by :func:`chan_params` so their float rounding is the reference's."""

    n: torch.Tensor       # int64 logical payload width (<= padded width)
    nf: torch.Tensor      # float32 float(n): the reference arm's divisor
    inv_n: torch.Tensor   # float32 f32(1/n): K1's ECDF multiplier
    d_crit: torch.Tensor  # float32 per-channel threshold (selector-scaled)
    err_cum: torch.Tensor  # bool cumulative error metric (delta mode)
    eb_on: torch.Tensor   # bool error-bound gate armed for this channel

    def block(self) -> torch.Tensor:
        """K1's (C, 8) float32 ``chan`` operand (``CHAN_*`` layout)."""
        z = torch.zeros_like(self.nf)
        return torch.stack([self.nf, self.inv_n, self.d_crit,
                            self.err_cum.float(), self.eb_on.float(),
                            z, z, z], dim=1)


def chan_params(n_valid, d_crit, err_cum, eb_on, device) -> ChanParams:
    """ChanParams from host values: ``inv_n`` is ``1/n`` in float64
    rounded to float32, as the static kernel's operand; ``n`` is at least
    1 (an inactive lane's guard)."""
    n = np.maximum(np.asarray(n_valid, np.int64), 1)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return ChanParams(
        n=t(n, torch.int64), nf=t(n.astype(np.float32), torch.float32),
        inv_n=t((1.0 / n.astype(np.float64)).astype(np.float32),
                torch.float32),
        d_crit=t(np.asarray(d_crit, np.float32), torch.float32),
        err_cum=t(err_cum, torch.bool), eb_on=t(eb_on, torch.bool))


def repad_state_n(state: DictState, n_new: int) -> DictState:
    """Re-pad the trailing payload-width axis of a (batched) mixed carry
    when the cohort's widest live width changes.  Grown columns are
    ``+inf`` (the pad value of inserted rows); shrinking slices pad columns
    off, which is sound because the session resets a lane before its width
    changes."""
    n_old = state.sorted_blocks.shape[-1]
    if n_new == n_old:
        return state

    def fit(a):
        if n_new > n_old:
            pad = a.new_full(a.shape[:-1] + (n_new - n_old,), float("inf"))
            return torch.cat([a, pad], dim=-1)
        return a[..., :n_new].contiguous()

    raw = state.raw_blocks
    if raw.shape[-2]:
        raw = fit(raw)
    return state._replace(sorted_blocks=fit(state.sorted_blocks),
                          raw_blocks=raw)


def _step_mixed(params: EncoderParams, chan: ChanParams, state: DictState,
                xs, valid, raw):
    """Masked variant of the plain step for C channels of padded width:
    every width-dependent quantity uses the channel's logical width with
    the +inf tail columns masked out, and the threshold and error metric
    come from ``chan``."""
    n_max = xs.shape[-1]
    col_ok = torch.arange(n_max, device=xs.device) < chan.n[:, None]
    xmax = torch.where(col_ok, xs, float("-inf")).amax(-1, keepdim=True)
    ok = state.valid
    if params.use_minmax:
        r = torch.tensor(params.rel_tol, dtype=state.dmin.dtype)
        ok = ok & minmax_gate(xs[:, :1], xmax, state.dmin, state.dmax, r)
    if params.use_ks:
        ks = ks_statistic_many_masked(xs, state.sorted_blocks, chan.nf,
                                      col_ok)
        ok = ok & (ks <= chan.d_crit[:, None])
    if params.error_bound is None:
        return _decide(state, xs, ok, valid, xmax=xmax)
    err_ok = error_gate(raw, state.raw_blocks, params.error_bound,
                        chan.err_cum, col_ok)
    ok = ok & (err_ok | ~chan.eb_on[:, None])
    return _decide(state, xs, ok, valid, raw, xmax)


def _resolve_mixed_matcher(matcher) -> str:
    """Only the reference and fused matchers have masked (width-aware)
    variants; ``"ops"``, ``"auto"`` and anything else take the session's
    per-channel loop instead."""
    if matcher is None or matcher == "reference":
        return "reference"
    if matcher == "fused":
        return "fused"
    raise ValueError(
        f"the mixed-mode scan has masked variants of the reference and "
        f"fused matchers only; got {matcher!r}")


def encode_decisions_mixed(
    blocks_cn: torch.Tensor,
    *,
    num_dict: int,
    n_valid,
    d_crit,
    rel_tol: float = 0.1,
    use_minmax: bool = True,
    use_ks: bool = True,
    error_bound: Optional[float] = None,
    error_cumulative=None,
    eb_on=None,
    matcher: Optional[str] = None,
    state: Optional[DictState] = None,
    valid: Optional[torch.Tensor] = None,
):
    """Batched mixed-mode encoder for adaptive heterogeneous channels.

    ``blocks_cn`` (C, nb, n_max): per-channel payloads padded on the width
    axis with ``+inf`` to the cohort's widest and on the block axis via
    ``valid`` (C, nb).  ``n_valid`` (C,) gives each channel's logical
    width, ``d_crit`` (C,) its threshold, ``error_cumulative`` (C,) its
    error metric under the shared ``error_bound`` and ``eb_on`` (C,)
    whether its bound is armed (host arrays).  ``matcher``: ``None`` or
    ``"reference"`` (the plain step loop, the reference package's
    ``"jax"`` arm) or ``"fused"`` (one K1 launch with its ``chan`` operand,
    the ``"pallas"`` arm).  Return forms as
    :func:`encode_decisions_batched`; the carry's width axis follows the
    cohort's widest -- repad with :func:`repad_state_n` when it changes.
    """
    C, nb, n = blocks_cn.shape
    dev = blocks_cn.device
    m = _resolve_mixed_matcher(matcher)
    return_state = state is not None
    if state is None:
        state = init_state(num_dict, n, dtype=blocks_cn.dtype, channels=C,
                           device=dev, raw=error_bound is not None)
    if error_bound is not None and state.raw_blocks.shape[-2] == 0:
        raise ValueError("error_bound requires a state created with "
                         "init_state(..., raw=True)")
    if valid is None:
        valid = torch.ones((C, nb), dtype=torch.bool, device=dev)
    chan = chan_params(
        n_valid, d_crit,
        np.zeros(C, bool) if error_cumulative is None else error_cumulative,
        np.ones(C, bool) if eb_on is None else eb_on, dev)
    xs_all = torch.sort(blocks_cn, dim=-1).values  # +inf pads sort last
    eb = None if error_bound is None else float(error_bound)
    if m == "fused":
        from ..kernels.encode_step import encode_scan
        out, state = encode_scan(xs_all, valid, state, d_crit=0.0,
                                 rel_tol=rel_tol, use_minmax=use_minmax,
                                 use_ks=use_ks, raw=blocks_cn,
                                 error_bound=eb, chan=chan.block())
    else:
        params = EncoderParams(0.0, float(rel_tol), bool(use_minmax),
                               bool(use_ks), error_bound=eb)
        acc = ([], [], [])
        for b in range(nb):
            state, dec = _step_mixed(params, chan, state, xs_all[:, b],
                                     valid[:, b], blocks_cn[:, b])
            for a, v in zip(acc, dec):
                a.append(v)
        out = (tuple(torch.stack(a, dim=1) for a in acc) if nb
               else _empty_decisions(C, dev))
    return (out, state) if return_state else out
