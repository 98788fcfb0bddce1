"""The least time a kernel's work takes on the card: the published peaks
and the operations and bytes of K1 (``csrc/encode_step.cu``) and K2
(``csrc/seq_cumsum.cu``) reckoned from the inputs they were given.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the full 700 W: HBM3
3.35 TB/s; 67 TFLOP/s float32 and 34 TFLOP/s float64 outside the tensor
cores.  A card set to a lower ``power.limit`` reaches less; the result
line carries the limit it ran at.

K1's count is ``chip_smoke.py:k1_work``'s (frozen here): per block step
the eq. 3 gate of every valid dictionary row (10 float32 operations) and,
for every row that passes it, the KS distance (about 12 operations a
sample); bytes are the valid blocks read once, the step mask, the
dictionary carry read and written once, and the decisions written once.
Adapted to a coalescer flush: the flush enters with the dictionary its
slots carried from the last flush, and pad steps do no work.  K2's count
is ``chip_smoke.py:time_k2``'s bytes: each row read once and written once.
"""
from __future__ import annotations

__all__ = ["HBM_BPS", "PEAK_F32", "PEAK_F64", "K1_GATE_OPS",
           "K1_KS_OPS_PER_SAMPLE", "least_seconds", "k1_flush_work",
           "k2_bytes"]

HBM_BPS = 3.35e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12
K1_GATE_OPS, K1_KS_OPS_PER_SAMPLE = 10, 12


def least_seconds(nbytes: float, ops: float, peak_ops: float = PEAK_F32):
    """(seconds, bound): the larger of bytes at HBM bandwidth and
    operations at ``peak_ops``, and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BPS, ops / peak_ops
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k1_flush_work(torch, xmin, xmax, step_valid, is_hit, dmin0, dmax0,
                  valid0, count0, rel_tol: float, n: int):
    """(bytes, operations) of one K1 launch over C channels and nb steps:
    the sorted blocks' extremes ``xmin``/``xmax`` (C, nb), the step mask
    ``step_valid`` (C, nb), the decisions' ``is_hit`` (C, nb), and the
    carry entering the launch, ``dmin0``/``dmax0``/``valid0`` (C, D) and
    ``count0`` (C,).  Each step's dictionary is replayed from the carry
    and the misses before it."""
    C, nb = xmin.shape
    D = dmin0.shape[1]
    dev = xmin.device
    miss = (~is_hit & step_valid).to(torch.int64)
    before = torch.cumsum(miss, dim=1) - miss
    slot = (count0.to(torch.int64)[:, None] + before) % D
    m = torch.full((C, nb, D), -1, dtype=torch.int64, device=dev)
    ci, bi = torch.nonzero(miss, as_tuple=True)
    m[ci, bi, slot[ci, bi]] = bi
    last = torch.cummax(m, dim=1).values
    last = torch.cat([torch.full((C, 1, D), -1, dtype=torch.int64,
                                 device=dev), last[:, :-1]], dim=1)
    fresh = last >= 0
    idx = last.clamp(min=0).reshape(C, -1)
    dmin = torch.where(fresh, torch.gather(xmin, 1, idx).reshape(C, nb, D),
                       dmin0[:, None, :])
    dmax = torch.where(fresh, torch.gather(xmax, 1, idx).reshape(C, nb, D),
                       dmax0[:, None, :])
    rows = (fresh | valid0[:, None, :]) & step_valid[..., None]
    r = torch.tensor(rel_tol, dtype=torch.float32, device=dev)
    t = (dmax - dmin) * r
    lo, hi = xmin[..., None], xmax[..., None]
    gate = rows & (lo >= dmin - t) & (lo <= dmin + t) \
        & (hi >= dmax - t) & (hi <= dmax + t)
    n_rows, n_ks = int(rows.sum()), int(gate.sum())
    n_blocks = int(step_valid.sum())
    nbytes = (n_blocks * n * 4 + C * nb + 2 * C * (D * n * 4 + D * 9 + 4)
              + C * nb * 6)
    ops = n_rows * K1_GATE_OPS + n_ks * K1_KS_OPS_PER_SAMPLE * n
    return nbytes, ops


def k2_bytes(rows: int, width: int, itemsize: int = 8) -> int:
    """Bytes of a sequential cumsum over ``rows`` x ``width`` values: read
    once, written once."""
    return 2 * rows * width * itemsize
