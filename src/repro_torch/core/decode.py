"""Decode engine: one reconstruction path for every consumer.

Reconstruction in IDEALEM (paper Sec. V-A2/V-B2) is per-block math: a hit
is either a random permutation of its source block (std mode) or the
stored transformed values re-anchored on the hit's own base (residual and
delta; delta adds an in-block cumsum).  A :class:`DecodePlan` is the
struct-of-arrays form of "what feeds each output block"; :func:`reconstruct`
turns it into samples.

Backends, all byte-identical:

  ``numpy``  -- the host reference (fancy-index gather + vectorized math);
  ``torch``  -- tensor gather / permutation apply / re-anchor / wrap on the
                given device, the delta cumsum as the plain column loop;
  ``cuda``   -- the same with the delta cumsum in the hand-written
                ``kernels.seq_cumsum`` kernel;
  ``auto``   -- the measured-best of the three for the plan's (mode,
                dtype, size bucket) on the device (:func:`resolve_backend`).

The device backends run on the device they are given or raise; there is no
fallback to the host path.  ``"auto"`` holds each device backend against
the host path on a probe plan before it may choose it, and raises when the
bytes differ.  Device shapes are padded to powers of two (pad rows are
zero-payload misses the per-block math ignores); the padding is done on the
device, so the host hands over each row once.

Routing is counted on the port's registry (``repro_torch.obs``) under the
reference's names: ``repro_decode_{host,device}_calls_total``,
``repro_decode_autotune_{probes,hits}_total`` and
``repro_decode_backend_calls_total{backend}``; :func:`decode_stats` is a
dict view of the first four and the ``"auto"`` table.  The port has no
host fallback, so it has no ``fallbacks`` counter.  A device dispatch is
also a ``decode.{perms,h2d,launch,d2h}`` span each, inside whatever span
is open, with its ``repro_decode_step_seconds{step}`` child, and counts
its blocks in ``repro_decode_rows_total{kind=requested|dispatched}``.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..api import BACKENDS
from ..device import resolve_device
from ..errors import StreamFormatError
from .transforms import np_wrap_range, wrap_range
from .tuning import AutotuneCacheError, MeasuredTuner, best_of, pow2_bucket

__all__ = ["MODE_STD", "MODE_RESIDUAL", "MODE_DELTA", "BACKENDS",
           "DecodePlan", "PlanPart", "decode_sources", "hit_perms",
           "gather_rows", "plan_from_parsed", "pad_parts", "reconstruct",
           "resolve_backend", "decode_stats", "reset_decode_stats",
           "AUTOTUNE_VERSION", "AutotuneCacheError", "load_autotune",
           "save_autotune", "reset_autotune", "autotune_choices",
           "autotune_cached"]

MODE_STD, MODE_RESIDUAL, MODE_DELTA = 0, 1, 2

logger = logging.getLogger("repro_torch.core.decode")

_stat_counters = {
    key: obs.registry().counter(f"repro_decode_{key}_total", help_text)
    for key, help_text in {
        "host_calls": "reconstruct calls served on the numpy host path",
        "device_calls": "reconstruct calls served on a device backend",
        "autotune_probes": "backend=auto measured first-use probes",
        "autotune_hits": "backend=auto cached resolutions",
    }.items()
}
_backend_counters = {
    b: obs.registry().counter("repro_decode_backend_calls_total",
                              "reconstruct calls per resolved backend",
                              labels={"backend": b})
    for b in BACKENDS
}
_step_seconds = {
    step: obs.registry().histogram(
        "repro_decode_step_seconds",
        "device reconstruct wall time by step, each over the whole dispatch",
        labels={"step": step})
    for step in ("perms", "h2d", "launch", "d2h")
}
_rows = {
    kind: obs.registry().counter(
        "repro_decode_rows_total",
        "device reconstruct blocks: requested, and dispatched after padding",
        labels={"kind": kind})
    for kind in ("requested", "dispatched")
}


def decode_stats() -> dict:
    """``host_calls``, ``device_calls``, ``autotune_probes`` and
    ``autotune_hits`` since the last reset, and ``autotune_choices``, the
    ``"auto"`` routing table."""
    snap = {key: int(c.value) for key, c in _stat_counters.items()}
    return {**snap, "autotune_choices": autotune_choices()}


def reset_decode_stats() -> None:
    for c in (*_stat_counters.values(), *_backend_counters.values()):
        c.reset()


@dataclass(frozen=True)
class DecodePlan:
    """Everything :func:`reconstruct` needs, as flat arrays.

    ``payloads`` holds each *source* block's stored values once (misses in
    stream order).  ``src[i]`` is the payload row feeding output block
    ``i``; hits share their source miss's row.  ``block_idx[i]`` is the
    block's global position in its stream: std-mode hit permutations are
    keyed on ``(seed, block_idx)`` (:func:`hit_perms`).  ``no_perm``
    (error-bounded streams) pins std-mode hits to the stored row order.
    ``requested`` is the real blocks among ``nb`` (:func:`pad_parts`'
    plans hold padding too); ``None`` means all of them.
    """

    mode: int
    block_size: int
    dtype: np.dtype
    value_range: Optional[Tuple[float, float]]
    payloads: np.ndarray            # (n_rows, P) source payload rows
    src: np.ndarray                 # (nb,) payload row per output block
    bases: Optional[np.ndarray]     # (nb,) res/delta modes, else None
    is_hit: np.ndarray              # (nb,) bool
    block_idx: np.ndarray           # (nb,) global block positions
    seed: int = 0
    overwrite: Optional[np.ndarray] = None  # (nb,) bool, informational
    no_perm: bool = False
    requested: Optional[int] = None

    @property
    def nb(self) -> int:
        return len(self.src)

    @property
    def payload_width(self) -> int:
        return int(self.payloads.shape[1])


class PlanPart(NamedTuple):
    """One request's worth of plan inputs, sources already resolved
    (``rows[i]`` is the payload feeding the part's block ``i``).  Parts of
    many requests are padded into one :class:`DecodePlan` by
    :func:`pad_parts`."""

    rows: np.ndarray                # (n, P) per-block source payloads
    bases: Optional[np.ndarray]     # (n,) or None (std mode)
    is_hit: np.ndarray              # (n,) bool
    block_idx: np.ndarray           # (n,) global block positions


# ------------------------------------------------------- plan construction

def decode_sources(is_hit: np.ndarray, slot: np.ndarray) -> np.ndarray:
    """Payload row (miss ordinal) feeding each block: misses feed
    themselves, hits feed the most recent miss written to their slot.
    A hit with no preceding miss on its slot is malformed input."""
    nb = len(is_hit)
    miss_pos = np.flatnonzero(~is_hit)
    hit_pos = np.flatnonzero(is_hit)
    src = np.zeros(nb, dtype=np.int64)
    src[miss_pos] = np.arange(len(miss_pos))
    if len(hit_pos):
        hit_slots = slot[hit_pos]
        miss_slots = slot[miss_pos]
        for s in np.unique(hit_slots):
            hp = hit_pos[hit_slots == s]
            mp = miss_pos[miss_slots == s]
            j = np.searchsorted(mp, hp) - 1
            if len(mp) == 0 or np.any(j < 0):
                raise StreamFormatError(f"hit on slot {s} before any miss")
            src[hp] = src[mp[j]]
    return src


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer on uint64 arrays (wrapping arithmetic is the
    point; numpy only flags the wrap for 0-d inputs)."""
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def hit_perms(seed: int, block_idx: np.ndarray, B: int) -> np.ndarray:
    """Per-hit reconstruction permutations, stateless in the block position:
    the argsort of SplitMix64 keys of (seed, global sample index)."""
    with np.errstate(over="ignore"):  # seed 2**64-1 wraps on the +1
        s = _splitmix64(np.uint64(seed & 0xFFFFFFFFFFFFFFFF) + np.uint64(1))
        samp = (np.asarray(block_idx, dtype=np.uint64)[:, None] * np.uint64(B)
                + np.arange(B, dtype=np.uint64)[None, :])
    return np.argsort(_splitmix64(samp ^ s), axis=1, kind="stable")


def gather_rows(u8: np.ndarray, dt: np.dtype, offs: np.ndarray,
                width: int) -> np.ndarray:
    """One fancy-indexing pass over raw stream bytes: ``width``-value rows
    at byte offsets ``offs``."""
    if width == 0 or len(offs) == 0:
        return np.zeros((len(offs), width), dtype=dt)
    return u8[offs[:, None] + np.arange(width * dt.itemsize)].view(dt)


def plan_from_parsed(header, parsed, seed: int = 0, i0: int = 0) -> DecodePlan:
    """Plan for a full sequential decode of one parsed stream section;
    block positions are ``i0..i0+nb``."""
    nb = len(parsed.is_hit)
    return DecodePlan(
        mode=header.mode, block_size=header.block_size,
        dtype=np.dtype(header.dtype), value_range=header.value_range,
        payloads=parsed.payloads,
        src=decode_sources(parsed.is_hit, parsed.slot),
        bases=parsed.bases, is_hit=parsed.is_hit,
        block_idx=i0 + np.arange(nb, dtype=np.int64), seed=seed,
        overwrite=parsed.overwrite,
        no_perm=bool(getattr(header, "error_bounded", False)))


def pad_parts(mode: int, block_size: int, dtype, value_range,
              parts: Sequence[PlanPart], seed: int = 0,
              no_perm: bool = False) -> Tuple[DecodePlan, int]:
    """Pad R ragged request parts into ONE plan of shape ``(R * nbm,)``.

    Requests are stacked on a leading axis and padded to the longest; pad
    blocks are misses on a shared all-zero payload row, which the per-block
    math ignores.  Each part's rows are copied once, into the plan's
    payloads.  Returns ``(plan, nbm)``; callers reshape
    ``reconstruct(plan)`` to ``(R, nbm, B)`` and slice each request back
    out.
    """
    dt = np.dtype(dtype)
    R = len(parts)
    lens = [len(p.is_hit) for p in parts]
    nbm = max(lens)
    P = block_size if mode == MODE_STD else block_size - 1
    n_rows = sum(lens)
    payloads = np.empty((n_rows + 1, P), dtype=dt)   # last row: shared pad
    payloads[n_rows] = 0
    src = np.full((R, nbm), n_rows, dtype=np.int64)
    is_hit = np.zeros((R, nbm), dtype=bool)
    block_idx = np.zeros((R, nbm), dtype=np.int64)
    bases = None if mode == MODE_STD else np.zeros((R, nbm), dtype=dt)
    pos = 0
    for r, (p, n) in enumerate(zip(parts, lens)):
        payloads[pos:pos + n] = p.rows
        src[r, :n] = np.arange(pos, pos + n)
        is_hit[r, :n] = p.is_hit
        block_idx[r, :n] = p.block_idx
        if bases is not None:
            bases[r, :n] = p.bases
        pos += n
    plan = DecodePlan(
        mode=mode, block_size=block_size, dtype=dt, value_range=value_range,
        payloads=payloads, src=src.ravel(),
        bases=None if bases is None else bases.ravel(),
        is_hit=is_hit.ravel(), block_idx=block_idx.ravel(), seed=seed,
        no_perm=no_perm, requested=n_rows)
    return plan, nbm


def _perm_hits(plan: DecodePlan) -> np.ndarray:
    return (np.zeros(0, dtype=np.int64) if plan.no_perm
            else np.flatnonzero(plan.is_hit))


# ------------------------------------------------------------ numpy backend

def _reconstruct_numpy(plan: DecodePlan) -> np.ndarray:
    rows = plan.payloads[plan.src]          # fancy index: always a fresh copy
    if plan.mode == MODE_STD:
        out = rows
        hit_pos = _perm_hits(plan)
        if len(hit_pos):
            perm = hit_perms(plan.seed, plan.block_idx[hit_pos],
                             plan.block_size)
            out[hit_pos] = np.take_along_axis(rows[hit_pos], perm, axis=1)
        return out
    base = plan.bases[:, None]
    t = rows if plan.mode == MODE_RESIDUAL else np.cumsum(rows, axis=1)
    out = np.concatenate([base, base + t], axis=1)
    if plan.value_range is not None:
        out = np_wrap_range(out, *plan.value_range)
    return out


# ----------------------------------------------------------- device backends

def _pow2(n: int) -> int:
    return max(1, 1 << (int(n) - 1).bit_length())


def _padded(a: np.ndarray, n: int, fill, device: torch.device):
    """``a`` (host) in the first rows of an ``n``-row tensor on ``device``,
    the rest ``fill``: one copy of the host rows, the padding written on
    the device."""
    host = torch.from_numpy(np.asarray(a))
    out = torch.empty((n,) + host.shape[1:], dtype=host.dtype, device=device)
    out[:len(host)].copy_(host)
    out[len(host):] = fill
    return out


def _step(step: str):
    """Span ``decode.<step>`` and its ``repro_decode_step_seconds`` child
    around one step of a device dispatch."""
    return obs.span(f"decode.{step}", seconds=_step_seconds[step])


def _run_device(plan: DecodePlan, backend: str,
                device: torch.device) -> np.ndarray:
    """Gather, permutation apply, re-anchor, (delta) sequential cumsum and
    wrap on ``device``; shapes padded to powers of two.  Each of its four
    steps (the autotuner's probes' too) is a :func:`_step`: the host's
    permutations, the copies in, the enqueue, and the copy out with the
    wait for it."""
    from ..kernels.seq_cumsum import seq_cumsum, seq_cumsum_torch

    nb = plan.nb
    nbp, nrp = _pow2(nb), _pow2(len(plan.payloads) + 1)
    std = plan.mode == MODE_STD
    with _step("perms"):
        perm = None
        if std:
            perm = np.broadcast_to(
                np.arange(plan.block_size, dtype=np.int64),
                (nbp, plan.block_size)).copy()
            hit_pos = _perm_hits(plan)
            if len(hit_pos):
                perm[hit_pos] = hit_perms(plan.seed, plan.block_idx[hit_pos],
                                          plan.block_size)
    with _step("h2d"):
        payloads = _padded(plan.payloads, nrp, 0, device)
        src = _padded(plan.src, nbp, nrp - 1, device)  # pads read a zero row
        if std:
            perm = torch.from_numpy(perm).to(device)
        else:
            b = _padded(plan.bases, nbp, 0, device)[:, None]
    with _step("launch"):
        rows = payloads.index_select(0, src)
        del payloads
        if std:
            out = torch.gather(rows, 1, perm)
        else:
            if plan.mode == MODE_RESIDUAL:
                t = rows
            elif backend == "cuda":
                t = seq_cumsum(rows)
            else:
                t = seq_cumsum_torch(rows)
            out = torch.cat([b, b + t], dim=1)
            if plan.value_range is not None:
                out = wrap_range(out, *plan.value_range)
    with _step("d2h"):
        return out[:nb].cpu().numpy()


# ------------------------------------------------------ measured autotuner
#
# ``backend="auto"``: the first time a (mode, dtype, size bucket) is
# resolved on a device type, the engine holds the ``torch`` and ``cuda``
# backends against the host path on a small probe plan (raising when the
# bytes differ), times all three on a bucket-sized probe plan, routes the
# combination to the fastest and remembers the choice.  Choices persist in
# a versioned JSON cache when ``REPRO_TORCH_DECODE_AUTOTUNE`` names a path
# (the reference package's ``REPRO_DECODE_AUTOTUNE`` is never read); a
# stale or corrupt file is discarded and re-probed.  The table is
# ``core.tuning.MeasuredTuner``, as for the encoder's ``matcher="auto"``.

AUTOTUNE_VERSION = 1
_BUCKET_MIN, _BUCKET_MAX = 64, 16384

_TUNER = MeasuredTuner(
    version=AUTOTUNE_VERSION, env_var="REPRO_TORCH_DECODE_AUTOTUNE",
    validate_entry=lambda ent: ent.get("backend") in BACKENDS, log=logger,
    name="decode")
_exact_ok: set = set()  # (backend, mode, dtype, range, B, device type)


def _probe_plan(mode: int, dtype, value_range, block_size: int,
                nb: int = 16, n_rows: int = 5) -> DecodePlan:
    """Small deterministic plan with mantissa-rich values: hits, misses,
    shared sources and (delta) long accumulation chains all present.
    The defaults are the exactness probe's; the autotuner reuses this with
    ``nb`` at the size bucket it is timing."""
    dt = np.dtype(dtype)
    B = block_size
    P = B if mode == MODE_STD else B - 1
    bits = _splitmix64(np.arange(n_rows * P, dtype=np.uint64) + np.uint64(7))
    vals = (bits.astype(np.float64) / 2.0 ** 64 - 0.5) * 8.0
    payloads = vals.reshape(n_rows, P).astype(dt)
    src = (np.arange(nb, dtype=np.int64) * 3) % n_rows
    is_hit = np.ones(nb, dtype=bool)
    is_hit[:n_rows] = False
    bases = None
    if mode != MODE_STD:
        bbits = _splitmix64(np.arange(nb, dtype=np.uint64) + np.uint64(99))
        bases = ((bbits.astype(np.float64) / 2.0 ** 64 - 0.5) * 700.0
                 ).astype(dt)
    return DecodePlan(mode=mode, block_size=B, dtype=dt,
                      value_range=value_range, payloads=payloads, src=src,
                      bases=bases, is_hit=is_hit,
                      block_idx=np.arange(nb, dtype=np.int64), seed=3)


def _check_exact(backend: str, mode: int, dtype, value_range,
                 block_size: int, device: torch.device) -> None:
    """Hold ``backend`` against the host path on the exactness probe
    (once per combination); raise when its bytes differ."""
    key = (backend, mode, np.dtype(dtype).str, value_range, block_size,
           device.type)
    if key in _exact_ok:
        return
    probe = _probe_plan(mode, dtype, value_range, block_size)
    got = _run_device(probe, backend, device)
    if got.tobytes() != _reconstruct_numpy(probe).tobytes():
        raise RuntimeError(f"decode backend {backend!r} is not byte-exact "
                           f"against the host path for {key}")
    _exact_ok.add(key)


def _size_bucket(nb: int) -> int:
    """Pow-2 size bucket of a dispatch, clamped so the probe table stays
    small: everything below 64 blocks shares one bucket (dispatch overhead
    dominates), everything above 16384 another (bandwidth dominates)."""
    return pow2_bucket(nb, _BUCKET_MIN, _BUCKET_MAX)


def _autotune_key(mode: int, dtype, nb: int, device=None) -> str:
    return (f"mode={mode}|dtype={np.dtype(dtype).str}"
            f"|bucket={_size_bucket(nb)}"
            f"|device={resolve_device(device).type}")


def load_autotune(path: str, strict: bool = True) -> int:
    """Load persisted ``"auto"`` choices; returns the entry count.
    ``strict=True`` raises :class:`AutotuneCacheError` on a corrupt or
    version-stale file; ``strict=False`` logs, discards, and leaves the
    table cold so combinations are re-probed."""
    return _TUNER.load(path, strict=strict)


def save_autotune(path: str) -> None:
    """Persist the in-memory choices (atomic replace)."""
    _TUNER.save(path)


def reset_autotune() -> None:
    """Forget every choice, every exactness verdict and the lazy disk
    load: the next ``"auto"`` resolution re-probes."""
    _TUNER.reset()
    _exact_ok.clear()


def autotune_choices() -> dict:
    """Current ``"auto"`` routing table: autotune key -> backend name."""
    return _TUNER.choices("backend")


def autotune_cached(mode: int, dtype, nb: int, device=None) -> bool:
    """Whether ``"auto"`` for this (mode, dtype, size bucket) on ``device``
    would resolve from the table (True) or run a timing probe (False).
    The serving layer quiesces its pipeline before a cold probe: timing
    backends while a reconstruct is in flight would poison the choice."""
    return _TUNER.cached(_autotune_key(mode, dtype, nb, device))


def _probe_autotune(mode: int, dtype, value_range, block_size: int,
                    bucket: int, device: torch.device) -> dict:
    """Time the host path against ``torch`` and ``cuda`` on a bucket-sized
    probe plan (pow-2 shapes, the ones real traffic reuses), each device
    backend first held exact.  A device backend must be more than 5 %
    faster than the host path to take the route."""
    plan = _probe_plan(mode, dtype, value_range, block_size,
                       nb=bucket, n_rows=min(bucket, 64))
    times = {"numpy": best_of(lambda: _reconstruct_numpy(plan))}
    for b in BACKENDS[1:]:
        _check_exact(b, mode, dtype, value_range, block_size, device)
        times[b] = best_of(lambda: _run_device(plan, b, device))
    backend = min(sorted(times), key=times.get)
    if times[backend] > times["numpy"] * 0.95:
        backend = "numpy"
    return {"backend": backend,
            "times_us": {k: round(v * 1e6, 3) for k, v in times.items()}}


def resolve_backend(backend: str, mode: int, dtype, nb: int,
                    value_range=None, block_size: int = 32,
                    device=None) -> str:
    """Concrete backend for one dispatch.

    Explicit names pass through (validated); ``"auto"`` returns the
    measured-best backend for ``(mode, dtype, size bucket)`` on ``device``
    (default ``"cuda"``, raising without a GPU), probing, recording and
    (when ``REPRO_TORCH_DECODE_AUTOTUNE`` is set) persisting on first use.
    ``nb`` must be the size of the dispatch being routed (a serving
    layer's merged group, not one request).  A probe that fails, or a
    device backend whose probe bytes differ from the host path's, raises.
    """
    if backend != "auto":
        if backend not in BACKENDS:
            raise ValueError(f"unknown decode backend {backend!r}; "
                             f"expected one of {BACKENDS + ('auto',)}")
        return backend
    device = resolve_device(device)
    key = _autotune_key(mode, dtype, nb, device)
    with _TUNER.lock:
        hit = _TUNER.cached(key)
        ent = _TUNER.resolve(key, lambda: _probe_autotune(
            mode, np.dtype(dtype), value_range, block_size,
            _size_bucket(nb), device))
        _stat_counters["autotune_hits" if hit else "autotune_probes"].inc()
    if not hit:
        logger.info("decode autotune: %s -> %s %s", key, ent["backend"],
                    ent["times_us"])
    return ent["backend"]


def reconstruct(plan: DecodePlan, backend: str = "cuda",
                device=None) -> np.ndarray:
    """Rebuild ``(nb, B)`` block values from a plan (paper Sec. V-A2/V-B2).

    ``backend`` is ``"cuda"`` (default), ``"torch"``, ``"numpy"`` (the
    host reference, which ignores ``device``) or ``"auto"`` (the measured
    choice for the plan's mode, dtype and size bucket,
    :func:`resolve_backend`).  The tensor backends run on ``device``,
    default ``"cuda"``, which raises without a GPU; ``"cuda"`` on a CPU
    device runs the kernel's plain version.  Every backend is
    byte-identical.
    """
    if backend != "auto" and backend not in BACKENDS:
        raise ValueError(f"unknown decode backend {backend!r}; expected one "
                         f"of {BACKENDS + ('auto',)}")
    if plan.nb == 0:
        return np.zeros((0, plan.block_size), dtype=np.dtype(plan.dtype))
    backend = resolve_backend(backend, plan.mode, plan.dtype, plan.nb,
                              plan.value_range, plan.block_size, device)
    if backend == "numpy":
        out = _reconstruct_numpy(plan)
    else:
        out = _run_device(plan, backend, resolve_device(device))
        _rows["requested"].inc(plan.nb if plan.requested is None
                               else plan.requested)
        _rows["dispatched"].inc(_pow2(plan.nb))
    _backend_counters[backend].inc()
    _stat_counters["host_calls" if backend == "numpy"
                   else "device_calls"].inc()
    return out
