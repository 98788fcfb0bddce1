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

Scale-out (an encode plan's device grid, ``repro_torch.launch.encode_plan``):
:func:`encode_decisions_sharded` and :func:`encode_decisions_mixed_sharded`
split the channels over devices, :func:`encode_decisions_dsharded` splits
each channel's dictionary rows as well and takes each step's lowest
passing row across the shards; their carry is a :class:`ShardedState`
(:func:`split_state` / :func:`join_state`).  Decisions are the unsharded
scan's.
"""
from __future__ import annotations

import logging
from typing import NamedTuple, Optional, Tuple

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
           "ShardedState", "ShardPartition", "state_partition",
           "init_sharded_state", "split_state", "join_state", "reset_channel",
           "encode_decisions_sharded", "encode_decisions_mixed_sharded",
           "encode_decisions_dsharded", "MATCHERS",
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
    return _insert(state, xs, best, valid, ids, num_dict, raw, xmax)


def _insert(state: DictState, xs, best, valid, ids, num_dict: int, raw=None,
            xmax=None):
    """:func:`_decide` from the lowest passing global row ``best`` (C,)
    (``SENTINEL`` for none) over a carry whose rows have the global
    indices ``ids`` (D_shard,) of a dictionary of ``num_dict`` logical
    rows.  Only the row whose index is the FIFO slot ``count % num_dict``
    takes an insert, so a dictionary shard that does not own the slot (and
    any pad row, whose index is ``num_dict`` or more) passes its rows
    through; ``count`` advances alike on every shard."""
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


def _passing(matcher: str, params: EncoderParams, state: DictState, xs,
             raw):
    """``ok`` (C, D): the carry's rows that sorted candidates ``xs`` (C, n)
    (raw rows ``raw`` (C, n)) may hit.  ``matcher`` is ``"reference"``
    (plain tensor matching) or ``"ops"`` (K3)."""
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
    if params.error_bound is not None:
        ok = ok & error_gate(raw, state.raw_blocks, params.error_bound,
                             params.error_cumulative)
    return ok


def _step(matcher: str, params: EncoderParams, state: DictState, xs, valid,
          raw):
    """One step for C channels: sorted candidates ``xs`` (C, n), their raw
    rows ``raw`` (C, n), ragged-padding mask ``valid`` (C,)."""
    ok = _passing(matcher, params, state, xs, raw)
    return _decide(state, xs, ok, valid,
                   None if params.error_bound is None else raw)


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
        # a step with no valid channel (the padding of a coalescer's
        # block bucket) leaves the carry as it is and decides all-zero
        # (``_decide``): it is skipped, and its zeros written directly
        live = valid.any(dim=0).tolist()
        idle = (torch.zeros(C, dtype=torch.bool, device=dev),
                torch.zeros(C, dtype=torch.int32, device=dev),
                torch.zeros(C, dtype=torch.bool, device=dev))
        acc = ([], [], [])
        for b in range(nb):
            dec = idle
            if live[b]:
                state, dec = _step(m, params, state, xs_all[:, b],
                                   valid[:, b], blocks_cn[:, b])
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


# ------------------------------------------------------- sharded scale-out
#
# One process drives every shard.  A plan's devices form a (channel groups,
# dictionary shards) grid of ``torch.device``s, and a device may appear
# more than once (several shards on one card, or on the CPU).  Each shard
# keeps its slice of the carry resident on its device between calls.

class ShardedState(NamedTuple):
    """A batched carry split over a grid of shards: ``grid[g][s]`` is the
    ``DictState`` of channel group ``g``'s dictionary shard ``s`` on that
    shard's device -- the group's channels, and a contiguous run of the
    dictionary's rows padded to a multiple of the shard count (pad rows
    stay ``valid=False``).  ``count`` is replicated over a group's
    dictionary shards.  :func:`join_state` gives the logical carry."""

    grid: Tuple[Tuple[DictState, ...], ...]
    num_dict: int   # logical D

    @property
    def shard_channels(self) -> int:
        return self.grid[0][0].count.shape[0]

    @property
    def partition(self) -> "ShardPartition":
        return state_partition(self.grid, self.shard_channels * len(self.grid),
                               self.num_dict)

    def map(self, fn) -> "ShardedState":
        """Apply ``fn`` (DictState -> DictState) to every shard's carry."""
        return self._replace(grid=tuple(tuple(fn(st) for st in row)
                                        for row in self.grid))


def _copy_to(t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device`` (never a view of ``t``)."""
    return t.to(device, copy=True, memory_format=torch.contiguous_format)


class ShardPartition(NamedTuple):
    """How a carry splits over a shard grid (:func:`state_partition`):
    shard ``(g, s)`` holds channel group ``g``'s ``shard_channels``
    channels and dictionary shard ``s``'s ``shard_rows`` padded rows."""

    shard_channels: int
    shard_rows: int

    def channel_slice(self, group: int) -> slice:
        return slice(group * self.shard_channels,
                     (group + 1) * self.shard_channels)

    def row_slice(self, shard: int) -> slice:
        return slice(shard * self.shard_rows, (shard + 1) * self.shard_rows)

    def row_ids(self, shard: int, device) -> torch.Tensor:
        """The global (logical) indices of shard ``shard``'s rows."""
        return shard * self.shard_rows + torch.arange(
            self.shard_rows, dtype=torch.int32, device=device)


def state_partition(grid, channels: int, num_dict: int) -> ShardPartition:
    """The one place that knows how a carry splits over a shard grid:
    ``channels`` channels (a multiple of the grid's channel groups) split
    evenly over its groups, and ``num_dict`` rows padded to a multiple of
    its dictionary shards split evenly over them."""
    groups, shards = len(grid), len(grid[0])
    if channels % groups:
        raise ValueError(
            f"channels={channels} not divisible by the {groups} channel "
            f"shards; pad via EncodePlan")
    return ShardPartition(channels // groups, -(-num_dict // shards))


def init_sharded_state(num_dict: int, n: int, grid, *, channels: int,
                       dtype=torch.float32, raw: bool = False
                       ) -> ShardedState:
    """Fresh carry of ``channels`` channels split over ``grid``: each shard
    an empty dictionary of its padded row count on its device."""
    p = state_partition(grid, channels, num_dict)
    return ShardedState(tuple(
        tuple(init_state(p.shard_rows, n, dtype=dtype,
                         channels=p.shard_channels, device=dev,
                         raw=raw) for dev in row) for row in grid), num_dict)


def split_state(state: DictState, grid) -> ShardedState:
    """Split a batched logical carry over ``grid`` (copies on the shards'
    devices; pad rows zero and invalid)."""
    C, D = state.sorted_blocks.shape[:2]
    p = state_partition(grid, C, D)
    pad = p.shard_rows * len(grid[0]) - D

    def padded(f):
        if pad == 0 or f.shape[1] == 0:   # (C, 0, n): the bound is off
            return f
        return torch.cat([f, f.new_zeros((C, pad) + f.shape[2:])], dim=1)

    fields = {k: padded(f) for k, f in state._asdict().items()
              if k != "count"}
    out = []
    for g, row in enumerate(grid):
        ch = p.channel_slice(g)
        shards = []
        for s, dev in enumerate(row):
            r = p.row_slice(s)
            part = {k: _copy_to(f[ch, r] if f.shape[1] else f[ch], dev)
                    for k, f in fields.items()}
            shards.append(DictState(count=_copy_to(state.count[ch], dev),
                                    **part))
        out.append(tuple(shards))
    return ShardedState(tuple(out), D)


def join_state(state: ShardedState, device=None) -> DictState:
    """The logical carry of a split one, on ``device`` (default the first
    shard's): rows joined and cut back to ``num_dict``, ``count`` from
    each group's first shard, groups joined on the channel axis."""
    dev = state.grid[0][0].count.device if device is None else device
    D = state.num_dict
    groups = []
    for row in state.grid:
        def rows(k):
            parts = [getattr(st, k).to(dev) for st in row]
            if parts[0].shape[1] == 0:
                return parts[0]
            return torch.cat(parts, dim=1)[:, :D]
        groups.append(DictState(
            sorted_blocks=rows("sorted_blocks"), dmin=rows("dmin"),
            dmax=rows("dmax"), valid=rows("valid"),
            count=row[0].count.to(dev), raw_blocks=rows("raw_blocks")))
    return DictState(*(torch.cat(f, dim=0) for f in zip(*groups)))


def reset_channel(state, c: int) -> None:
    """Drop channel ``c``'s dictionary in place (a recycled coalescer slot,
    an adaptive lane's switch): its rows turn ``valid=False`` and its FIFO
    count rewinds.  ``state`` is a batched ``DictState`` or a
    ``ShardedState`` (every dictionary shard of the channel's group)."""
    if isinstance(state, ShardedState):
        g, c = divmod(c, state.shard_channels)
        shards = state.grid[g]
    else:
        shards = (state,)
    for st in shards:
        st.valid[c] = False
        st.count[c] = 0


def _sharded_state(state, grid, *, num_dict, n, channels, dtype, raw):
    """The carry a sharded scan starts from: ``state`` as given (split if
    it is a logical ``DictState``) or a fresh one."""
    if state is None:
        return init_sharded_state(num_dict, n, grid, channels=channels,
                                  dtype=dtype, raw=raw)
    if isinstance(state, DictState):
        state = split_state(state, grid)
    if (len(state.grid), len(state.grid[0])) != (len(grid), len(grid[0])):
        raise ValueError(
            f"carry split {len(state.grid)} x {len(state.grid[0])} does not "
            f"match the {len(grid)} x {len(grid[0])} shard grid")
    if raw and state.grid[0][0].raw_blocks.shape[-2] == 0:
        raise ValueError("error_bound requires a state created with "
                         "init_state(..., raw=True)")
    return state


def _gather(outs, dev):
    """Per-shard decision triples joined on the channel axis on ``dev``."""
    return tuple(torch.cat([o[i].to(dev) for o in outs], dim=0)
                 for i in range(3))


def _run_channel_shards(blocks_cn, valid, devices, state, scan):
    """Run ``scan(channels, blocks, valid, carry) -> (out, carry)`` on
    every channel shard, its slice of the blocks copied to its device;
    returns the joined decisions (on the first shard's device) and the
    split carry."""
    p = state.partition
    outs, grid = [], []
    for g, dev in enumerate(devices):
        ch = p.channel_slice(g)
        out, st = scan(ch, blocks_cn[ch].to(dev), valid[ch].to(dev),
                       state.grid[g][0])
        outs.append(out)
        grid.append((st,))
    return _gather(outs, devices[0]), state._replace(grid=tuple(grid))


def _channel_grid(devices):
    devices = [resolve_device(d) for d in devices]
    return devices, tuple((d,) for d in devices)


def encode_decisions_sharded(
    blocks_cn: torch.Tensor,
    *,
    devices,
    num_dict: int,
    d_crit: float,
    rel_tol: float = 0.1,
    use_minmax: bool = True,
    use_ks: bool = True,
    error_bound: Optional[float] = None,
    error_cumulative: bool = False,
    matcher: Optional[str] = None,
    state=None,
    valid: Optional[torch.Tensor] = None,
):
    """Scale-out :func:`encode_decisions_batched`: the channel axis of
    ``blocks_cn`` (C, nb, n) (on any device) is split evenly over
    ``devices``, and each shard runs the batched scan on its slice on its
    device (on ``"fused"`` one K1 launch a shard).  C must be a multiple of
    the shard count -- pad channels and mask them with ``valid`` (an
    ``EncodePlan`` computes the padding).  Decisions are those of the
    unsharded batched scan, bit for bit; they come back joined on the
    first shard's device.

    ``state`` is a logical ``DictState`` (split on entry) or the
    :class:`ShardedState` a previous call returned, whose shards stay on
    their devices; a resumable call returns the ``ShardedState``
    (:func:`join_state` gives the logical carry)."""
    C, nb, n = blocks_cn.shape
    devices, grid = _channel_grid(devices)
    m = resolve_matcher(matcher, num_dict=num_dict, n=n,
                        dtype=blocks_cn.dtype, device=devices[0])
    return_state = state is not None
    state = _sharded_state(state, grid, num_dict=num_dict, n=n, channels=C,
                           dtype=blocks_cn.dtype, raw=error_bound is not None)
    if valid is None:
        valid = torch.ones((C, nb), dtype=torch.bool)
    kw = dict(num_dict=num_dict, d_crit=d_crit, rel_tol=rel_tol,
              use_minmax=use_minmax, use_ks=use_ks, error_bound=error_bound,
              error_cumulative=error_cumulative, matcher=m)

    def scan(ch, blocks, v, st):
        return encode_decisions_batched(blocks, state=st, valid=v, **kw)

    out, state = _run_channel_shards(blocks_cn, valid, devices, state, scan)
    return (out, state) if return_state else out


def encode_decisions_mixed_sharded(
    blocks_cn: torch.Tensor,
    *,
    devices,
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
    state=None,
    valid: Optional[torch.Tensor] = None,
):
    """Channel-sharded :func:`encode_decisions_mixed`: the cohort's channel
    axis and its per-channel host arrays split over ``devices`` as in
    :func:`encode_decisions_sharded` (on ``"fused"`` one K1 launch with
    its ``chan`` operand a shard).  Inactive pad lanes carry
    ``valid=False`` blocks and any width; ``state`` and the return forms
    are those of :func:`encode_decisions_sharded`."""
    C, nb, n = blocks_cn.shape
    devices, grid = _channel_grid(devices)
    m = _resolve_mixed_matcher(matcher)
    return_state = state is not None
    state = _sharded_state(state, grid, num_dict=num_dict, n=n, channels=C,
                           dtype=blocks_cn.dtype, raw=error_bound is not None)
    if valid is None:
        valid = torch.ones((C, nb), dtype=torch.bool)
    lanes = dict(
        n_valid=np.asarray(n_valid), d_crit=np.asarray(d_crit),
        error_cumulative=np.zeros(C, bool) if error_cumulative is None
        else np.asarray(error_cumulative),
        eb_on=np.ones(C, bool) if eb_on is None else np.asarray(eb_on))

    def scan(ch, blocks, v, st):
        return encode_decisions_mixed(
            blocks, num_dict=num_dict, rel_tol=rel_tol,
            use_minmax=use_minmax, use_ks=use_ks, error_bound=error_bound,
            matcher=m, state=st, valid=v,
            **{k: a[ch] for k, a in lanes.items()})

    out, state = _run_channel_shards(blocks_cn, valid, devices, state, scan)
    return (out, state) if return_state else out


def _step_dshard(matcher: str, params: EncoderParams, num_dict: int,
                 states, ids, xs, valid, raw):
    """One block step of one channel group over its dictionary shards:
    per shard ``states[s]`` (rows with the global indices ``ids[s]``) and
    the step's operands on its device, ``xs[s]`` (C, n) sorted, ``valid[s]``
    (C,), ``raw[s]`` (C, n).  Each shard matches against its own rows and
    takes its lowest passing global index; the minimum over the shards
    (the reference's ``pmin``) is formed on the first shard's device and
    copied back; the shard that owns the FIFO slot takes the insert.
    Returns the new carries and the decisions (from the first shard)."""
    firsts = []
    for st, i, x, r in zip(states, ids, xs, raw):
        ok = _passing(matcher, params, st, x, r)
        firsts.append(torch.where(ok, i, SENTINEL).amin(-1))
    best = firsts[0]
    for f in firsts[1:]:
        best = torch.minimum(best, f.to(best.device))
    eb = params.error_bound is not None
    new, decs = [], []
    for st, i, x, v, r in zip(states, ids, xs, valid, raw):
        st, dec = _insert(st, x, best.to(x.device), v, i, num_dict,
                          r if eb else None)
        new.append(st)
        decs.append(dec)
    return new, decs[0]


def encode_decisions_dsharded(
    blocks_cn: torch.Tensor,
    *,
    grid,
    num_dict: int,
    d_crit: float,
    rel_tol: float = 0.1,
    use_minmax: bool = True,
    use_ks: bool = True,
    error_bound: Optional[float] = None,
    error_cumulative: bool = False,
    matcher: Optional[str] = None,
    state=None,
    valid: Optional[torch.Tensor] = None,
):
    """Dictionary-sharded encoder over a (channel groups, dictionary
    shards) ``grid`` of devices: channels split over the groups as in
    :func:`encode_decisions_sharded`, and within a group every channel's
    dictionary rows split over its shards (D padded to a multiple of the
    shard count with invalid rows).  Each block step runs the matcher on
    every shard's rows (on ``"ops"`` one K3 launch a shard), takes the
    lowest passing global row across the shards, and inserts on the shard
    that owns the FIFO slot.  Decisions are those of the unsharded batched
    scan, bit for bit.

    The fused scan cannot run here -- its in-kernel insert would have to
    follow the cross-shard minimum -- so ``"fused"``, and ``"auto"`` when
    it measures ``"fused"``, resolve to ``"ops"`` (K3), as in the reference
    package.  ``state`` and the return forms are those of
    :func:`encode_decisions_sharded`."""
    C, nb, n = blocks_cn.shape
    grid = tuple(tuple(resolve_device(d) for d in row) for row in grid)
    m = resolve_matcher(matcher, num_dict=num_dict, n=n,
                        dtype=blocks_cn.dtype, device=grid[0][0])
    if m == "fused":
        m = "ops"
    return_state = state is not None
    state = _sharded_state(state, grid, num_dict=num_dict, n=n, channels=C,
                           dtype=blocks_cn.dtype, raw=error_bound is not None)
    if valid is None:
        valid = torch.ones((C, nb), dtype=torch.bool)
    params = EncoderParams(
        float(d_crit), float(rel_tol), bool(use_minmax), bool(use_ks),
        error_bound=None if error_bound is None else float(error_bound),
        error_cumulative=bool(error_cumulative))
    p = state.partition
    outs, new_grid = [], []
    for g, row in enumerate(grid):
        ch = p.channel_slice(g)
        # the group's blocks once per distinct device, block-major so each
        # step's operands are contiguous; sorted once (hoisted)
        per_dev = {}
        for dev in row:
            if dev not in per_dev:
                b = blocks_cn[ch].to(dev)
                per_dev[dev] = tuple(t.transpose(0, 1).contiguous() for t in (
                    torch.sort(b, dim=-1).values, valid[ch].to(dev), b))
        ids = [p.row_ids(s, dev) for s, dev in enumerate(row)]
        states = list(state.grid[g])
        acc = ([], [], [])
        for b in range(nb):
            step = [tuple(t[b] for t in per_dev[dev]) for dev in row]
            states, dec = _step_dshard(
                m, params, num_dict, states, ids, *zip(*step))
            for a, v in zip(acc, dec):
                a.append(v)
        outs.append(tuple(torch.stack(a, dim=1) for a in acc) if nb
                    else _empty_decisions(p.shard_channels, row[0]))
        new_grid.append(tuple(states))
    out = _gather(outs, grid[0][0])
    state = state._replace(grid=tuple(new_grid))
    return (out, state) if return_state else out
