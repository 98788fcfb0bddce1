"""KS cross-check: the port's KS statistic and p-value against scipy's
oracles over a dense grid (far beyond the unit-test pins), on a device.

The counterpart of ``scripts/ks_crosscheck.py``, with its three sweeps
and tolerances, run on ``core/ks.py``'s tensor functions on ``--device``
(float32, as the reference's jax functions compute) and on the port's
numpy oracle (``core/npref.py``):

  * p-values against ``scipy.special.kolmogorov`` across (n, d), including
    the small-lambda region (lambda < 0.1), where both must return exactly
    1.0;
  * two-sample statistics against ``scipy.stats.ks_2samp`` on random
    pairs;
  * identical samples, whose p-value must be exactly 1.0 at every n (and
    equal ``ks_2samp(method="asymp")``'s), and ``critical_distance``
    inverting the p-value at alpha 0.01, 0.05, 0.1 and 0.2.

Exits 1 on any mismatch.  Usage:

  PYTHONPATH=src python -m repro_torch.launch.ks_crosscheck [--trials 200]
      [--device cuda]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import scipy.special
import scipy.stats
import torch

from ..core.ks import _SMALL_LAM, critical_distance, ks_pvalue, ks_statistic
from ..core.npref import ks_pvalue_np, ks_statistic_np
from ..device import resolve_device

__all__ = ["check_pvalue_grid", "check_statistic_random",
           "check_identical_accept", "main"]


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def check_pvalue_grid(device) -> int:
    bad = 0
    ns = [2, 4, 8, 16, 32, 64, 128, 255, 1024]
    for n in ns:
        en = np.sqrt(n / 2.0)  # sqrt(n1*n2/(n1+n2)) for n1 == n2 == n
        for d in np.concatenate([[0.0], np.geomspace(1e-8, 1.0, 120)]):
            lam = en * d
            ours = ks_pvalue_np(d, n, n)
            ours_dev = float(ks_pvalue(_f32(d, device), n, n))
            if lam < _SMALL_LAM:
                ok = ours == 1.0 and ours_dev == 1.0
                ref = 1.0
            else:
                ref = float(scipy.special.kolmogorov(lam))
                ok = (abs(ours - ref) <= 1e-9
                      and abs(ours_dev - ref) <= 1e-6)
            if not ok:
                bad += 1
                print(f"FAIL pvalue n={n} d={d:.3e} lam={lam:.3e} "
                      f"np={ours!r} {device.type}={ours_dev!r} ref={ref!r}")
    print(f"pvalue grid: {len(ns) * 121} points, {bad} failures")
    return bad


def check_statistic_random(trials: int, device, seed: int = 0) -> int:
    bad = 0
    rng = np.random.default_rng(seed)
    for t in range(trials):
        n1, n2 = int(rng.integers(4, 256)), int(rng.integers(4, 256))
        x = rng.normal(size=n1)
        y = rng.normal(rng.normal(0, 0.5), float(rng.uniform(0.5, 2)),
                       size=n2)
        ref = scipy.stats.ks_2samp(x, y).statistic
        if abs(ks_statistic_np(x, y) - ref) > 1e-12:
            bad += 1
            print(f"FAIL statistic trial={t} n1={n1} n2={n2}")
        if abs(float(ks_statistic(_f32(x, device), _f32(y, device)))
               - ref) > 1e-6:
            bad += 1
            print(f"FAIL statistic({device.type}) trial={t} n1={n1} n2={n2}")
    print(f"statistic random: {trials} trials, {bad} failures")
    return bad


def check_identical_accept(device) -> int:
    bad = 0
    rng = np.random.default_rng(1)
    for n in [4, 8, 16, 32, 64, 128, 255]:
        x = rng.normal(size=n)
        ref = scipy.stats.ks_2samp(x, x, method="asymp").pvalue
        p = ks_pvalue_np(ks_statistic_np(x, x), n, n)
        xd = _f32(x, device)
        p_dev = float(ks_pvalue(ks_statistic(xd, xd), n, n))
        if not (p == 1.0 and p_dev == 1.0 and abs(p - ref) <= 1e-12):
            bad += 1
            print(f"FAIL identical n={n} p={p!r} {device.type}={p_dev!r} "
                  f"ref={ref!r}")
        # the decision boundary stays invertible around every alpha
        for alpha in [0.01, 0.05, 0.1, 0.2]:
            dc = critical_distance(alpha, n, n)
            if abs(ks_pvalue_np(dc, n, n) - alpha) > 1e-6:
                bad += 1
                print(f"FAIL critical_distance n={n} alpha={alpha}")
    print(f"identical/critical: {bad} failures")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="device of the tensor functions (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    bad = (check_pvalue_grid(device)
           + check_statistic_random(args.trials, device)
           + check_identical_accept(device))
    print(f"ks_crosscheck ({device}):", "PASS" if bad == 0
          else f"FAIL ({bad})")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
