"""Plain PyTorch versions of the kernels' matching arithmetic.

:func:`ks_counts` is the KS distance as the TPU kernels compute it: ECDF
counts from broadcast compares (order-free, so rows may be in any order)
and gaps scaled by ``inv_n = f32(1/n)``, each product and difference
rounded in float32.  :func:`minmax_gate` (eq. 3) and :func:`error_gate`
(the error-bounded mode's pointwise check) are the gates beside it.  K1's
plain scan (``encode_step.py``), K3's plain matcher (:func:`dict_match_ref`)
and the encoder's plain steps (``core/encoder.py``) share them.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["ks_counts", "minmax_gate", "error_gate", "dict_match_ref"]


def ks_counts(xs: torch.Tensor, ds: torch.Tensor, inv_n,
              cols=None) -> torch.Tensor:
    """KS distance of sorted float32 candidates ``xs`` (..., n) against
    float32 rows ``ds`` (..., D, n) in any order -> (..., D) float32.

    d1 is taken at the candidate's points (``(j+1)/n`` against
    ``#{d <= x_j}/n``), d2 at each row's own points (``#{x <= d_k}/n``
    against the row's rank ``#{d <= d_k}/n``).  NaNs compare false and
    count 0, as in the kernels.

    ``inv_n`` is a float or, for the mixed-mode scan, a (C,) float32
    tensor, one per channel of (C, n) candidates; there ``cols`` (C, n)
    marks each channel's real columns: the counts still run over all n,
    the gaps of the other columns are zero-filled before the max (the TPU
    kernel's ``chan`` operand)."""
    n = xs.shape[-1]
    f32 = torch.float32
    if torch.is_tensor(inv_n):
        inv = inv_n[..., None, None]              # (C, 1, 1)
    else:
        inv = torch.tensor(inv_n, dtype=f32)  # CPU 0-dim: no copy, no sync
    x = xs[..., None, None, :]                    # (..., 1, 1, n_j)
    d_k = ds[..., :, :, None]                     # (..., D, n_k, 1)
    cnt_d = (d_k <= x).sum(-2).to(f32)            # (..., D, n_j): #{d <= x_j}
    f_x = (torch.arange(n, dtype=f32, device=xs.device) + 1.0) * inv
    a1 = torch.abs(f_x - cnt_d * inv)
    cnt_x = (x <= d_k).sum(-1).to(f32)            # (..., D, n_k): #{x <= d_k}
    rank_d = (ds[..., :, None, :] <= d_k).sum(-1).to(f32)  # #{d <= d_k}
    a2 = torch.abs(cnt_x * inv - rank_d * inv)
    if cols is not None:
        ok = cols[..., None, :]
        a1 = torch.where(ok, a1, 0.0)
        a2 = torch.where(ok, a2, 0.0)
    return torch.maximum(a1.amax(-1), a2.amax(-1))


def minmax_gate(xmin, xmax, dmin, dmax, r):
    """Eq. (3): both block extremes inside +-w*r of the stored extremes.
    ``r`` is a tensor of the carry's dtype, so each product and difference
    rounds in that dtype.

    Scalar operands of the steps are 0-dim tensors on the CPU: PyTorch
    takes them beside CUDA operands without a host-to-device copy, which
    would wait for the stream at every block step."""
    w = dmax - dmin
    t = w * r
    return ((xmin >= dmin - t) & (xmin <= dmin + t)
            & (xmax >= dmax - t) & (xmax <= dmax + t))


def error_gate(raw, raw_blocks, error_bound: float, cumulative, cols=None):
    """Per-row pointwise error check of raw blocks ``raw`` (C, n) against
    the stored raw rows (C, D, n): ``max|diff| <= bound`` (C, D), where
    diff is the payload difference (std/residual: decoded samples differ
    from the original by exactly this) or, with ``cumulative`` (delta:
    decoded samples are base + cumsum of stored diffs), its running sum.
    Computed in the carry's dtype; the running sum adds one column at a
    time, left to right (``torch.cumsum`` does not add in that order).  A
    NaN anywhere fails the row, as a NaN maximum does.

    For the mixed-mode scan ``cumulative`` may be a (C,) bool tensor, one
    metric per channel, and ``cols`` (C, n) marks each channel's real
    columns: the others (``+inf`` pads, whose difference is NaN) are left
    out."""
    diff = raw[:, None, :] - raw_blocks
    if torch.is_tensor(cumulative):
        run = diff.clone()
        for k in range(1, run.shape[-1]):
            run[..., k] += run[..., k - 1]
        diff = torch.where(cumulative[:, None, None], run, diff)
    elif cumulative:  # in place, one column at a time
        for k in range(1, diff.shape[-1]):
            diff[..., k] += diff[..., k - 1]
    ad = diff.abs()
    if cols is not None:
        ad = torch.where(cols[:, None, :], ad, 0.0)
    bound = torch.tensor(error_bound, dtype=diff.dtype)
    return (ad <= bound).all(-1)


def dict_match_ref(xs: torch.Tensor, rows: torch.Tensor, dmin: torch.Tensor,
                   dmax: torch.Tensor, rel_tol: float):
    """Plain version of K3: ``(ks, mm)`` of sorted candidates ``xs`` (C, n)
    against rows (C, D, n) in any order, with the eq. 3 gate on ``dmin`` /
    ``dmax`` (C, D).  Unbatched operands ((n,), (D, n), (D,)) give (D,)
    results.  Every operand is float32 (:func:`repro_torch.kernels.ops.
    dict_match` casts); ``rel_tol`` is rounded to float32 as the TPU
    kernel's operand is."""
    if xs.dim() == 1:
        ks, mm = dict_match_ref(xs[None], rows[None], dmin[None], dmax[None],
                                rel_tol)
        return ks[0], mm[0]
    ks = ks_counts(xs, rows, float(np.float32(1.0 / xs.shape[-1])))
    r = torch.tensor(float(np.float32(rel_tol)), dtype=torch.float32)
    mm = minmax_gate(xs[..., :1], xs[..., -1:], dmin, dmax, r)
    return ks, mm
