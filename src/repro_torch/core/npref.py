"""Pure-numpy reference encoder: the ``"numpy"`` backend and the decision
oracle for the tensor and kernel paths.

Mirrors the early-exit C encoder semantics exactly: for each block, walk the
dictionary in slot order, apply the min/max gate (eq. 3), the KS test and,
in the error-bounded mode, the pointwise error check; take the first
passing entry; FIFO insert on miss.

The dictionary carry is resumable: pass ``state=np_init_state(num_dict)``
and thread the returned state through chunked calls to get decisions
identical to one pass over the whole array.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .. import obs

__all__ = ["ks_statistic_np", "ks_pvalue_np", "NpDictState", "np_init_state",
           "encode_decisions_np", "encode_decisions_mixed_np"]


# Miss attribution: why a block failed to hit, by the deepest gate its
# dictionary walk got past -- cold dictionary, the min/max gate (eq. 3),
# the KS test, or the error-bound check.  Only this host walk sees the
# gates' outcomes (the scans return hit/slot/overwrite alone), so these
# counters fill on numpy-backend sessions and oracle runs only.
_MISS_COUNTERS = {
    reason: obs.registry().counter(
        "repro_encode_miss_total",
        "dictionary misses by deepest gate passed (host reference walk)",
        labels={"reason": reason})
    for reason in ("cold", "minmax", "ks", "error_bound")
}


def ks_statistic_np(x: np.ndarray, y: np.ndarray) -> float:
    xs, ys = np.sort(x), np.sort(y)
    n1, n2 = len(xs), len(ys)
    both = np.concatenate([xs, ys])
    f1 = np.searchsorted(xs, both, side="right") / n1
    f2 = np.searchsorted(ys, both, side="right") / n2
    return float(np.max(np.abs(f1 - f2)))


def ks_pvalue_np(d: float, n1: int, n2: int, terms: int = 40) -> float:
    en = n1 * n2 / (n1 + n2)
    lam = max(np.sqrt(en) * d, 1e-12)
    if lam < 0.1:  # keep byte-consistent with ks._SMALL_LAM
        return 1.0
    j = np.arange(1, terms + 1)
    q = 2.0 * np.sum((-1.0) ** (j - 1) * np.exp(-2.0 * j * j * lam * lam))
    return float(np.clip(q, 0.0, 1.0))


@dataclass
class NpDictState:
    """Host twin of ``encoder.DictState`` (mutated in place by the scan)."""

    blocks: List[Optional[np.ndarray]]
    dmin: np.ndarray
    dmax: np.ndarray
    count: int = 0


def np_init_state(num_dict: int) -> NpDictState:
    return NpDictState(
        blocks=[None] * num_dict,
        dmin=np.zeros(num_dict),
        dmax=np.zeros(num_dict),
    )


def encode_decisions_np(
    blocks: np.ndarray,
    *,
    num_dict: int,
    d_crit: float,
    rel_tol: float = 0.1,
    use_minmax: bool = True,
    use_ks: bool = True,
    error_bound: Optional[float] = None,
    error_cumulative: bool = False,
    state: Optional[NpDictState] = None,
) -> Tuple[np.ndarray, ...]:
    """Sequential early-exit reference; same outputs as
    ``encoder.encode_decisions``.

    With ``state``, continues from (and mutates) the given carry and returns
    ``((is_hit, slot, overwrite), state)``; without, runs one-shot and
    returns the plain decision triple.
    """
    return_state = state is not None
    if state is None:
        state = np_init_state(num_dict)
    nb, _ = blocks.shape
    dict_blocks, dmin, dmax = state.blocks, state.dmin, state.dmax
    is_hit = np.zeros(nb, dtype=bool)
    slot = np.zeros(nb, dtype=np.int32)
    overwrite = np.zeros(nb, dtype=bool)
    misses = {"cold": 0, "minmax": 0, "ks": 0, "error_bound": 0}
    for i in range(nb):
        x = blocks[i]
        xmin, xmax = float(np.min(x)), float(np.max(x))
        hit = -1
        # deepest gate any entry got past (0 = no valid entry, 1 = min/max,
        # 2 = KS, 3 = error bound)
        depth = 0
        for s in range(num_dict):
            if dict_blocks[s] is None:
                continue
            depth = max(depth, 1)
            if use_minmax:
                w = dmax[s] - dmin[s]
                t = w * rel_tol
                if not (
                    dmin[s] - t <= xmin <= dmin[s] + t
                    and dmax[s] - t <= xmax <= dmax[s] + t
                ):
                    continue
            depth = max(depth, 2)
            if use_ks and ks_statistic_np(x, dict_blocks[s]) > d_crit:
                continue
            depth = max(depth, 3)
            if error_bound is not None:
                # the stored raw row is what the no-permutation decode
                # reproduces, so max|diff| over it (or over its running sum
                # in delta mode) is the decode error
                diff = x - dict_blocks[s]
                if error_cumulative:
                    diff = np.cumsum(diff)
                if float(np.max(np.abs(diff))) > error_bound:
                    continue
            hit = s
            break
        if hit >= 0:
            is_hit[i], slot[i] = True, hit
        else:
            misses[("cold", "minmax", "ks", "error_bound")[depth]] += 1
            s = state.count % num_dict
            overwrite[i] = state.count >= num_dict
            slot[i] = s
            dict_blocks[s] = x.copy()
            dmin[s], dmax[s] = xmin, xmax
            state.count += 1
    for reason, n in misses.items():
        if n:
            _MISS_COUNTERS[reason].inc(n)
    out = (is_hit, slot, overwrite)
    return (out, state) if return_state else out


def encode_decisions_mixed_np(
    blocks_cn: np.ndarray,
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
    states: Optional[List[Optional[NpDictState]]] = None,
    valid: Optional[np.ndarray] = None,
):
    """Host oracle for ``encoder.encode_decisions_mixed``: slices each
    channel's real rows (``valid`` (C, nb) mask) and columns (logical
    width ``n_valid[ci]``, the rest are +inf pads) out of the padded
    cohort and runs the early-exit walk per channel with that channel's
    ``d_crit``/``error_cumulative``/``eb_on``.

    One-shot returns the (C, nb) decision triple with padded rows zeroed;
    with ``states`` (a list of per-channel ``NpDictState`` or ``None``
    entries, filled and mutated in place) it returns the resumable
    ``((is_hit, slot, overwrite), states)`` form.
    """
    blocks_cn = np.asarray(blocks_cn)
    C, nb = blocks_cn.shape[:2]
    return_state = states is not None
    if states is None:
        states = [None] * C
    n_valid = np.asarray(n_valid)
    d_crit = np.asarray(d_crit)
    is_hit = np.zeros((C, nb), dtype=bool)
    slot = np.zeros((C, nb), dtype=np.int32)
    overwrite = np.zeros((C, nb), dtype=bool)
    for ci in range(C):
        rows = (np.ones(nb, dtype=bool) if valid is None
                else np.asarray(valid)[ci])
        pj = blocks_cn[ci][rows, : int(n_valid[ci])]
        if states[ci] is None:
            states[ci] = np_init_state(num_dict)
        ec = (False if error_cumulative is None
              else bool(np.asarray(error_cumulative)[ci]))
        ebo = True if eb_on is None else bool(np.asarray(eb_on)[ci])
        (h, s, o), _ = encode_decisions_np(
            pj, num_dict=num_dict, d_crit=float(d_crit[ci]),
            rel_tol=rel_tol, use_minmax=use_minmax, use_ks=use_ks,
            error_bound=error_bound if ebo else None,
            error_cumulative=ec, state=states[ci])
        is_hit[ci][rows], slot[ci][rows], overwrite[ci][rows] = h, s, o
    out = (is_hit, slot, overwrite)
    return (out, states) if return_state else out
