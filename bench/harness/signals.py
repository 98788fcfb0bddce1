"""Seeded uPMU telemetry made on the device: the configuration's channels
as rows of a float64 table, copied once to host memory.

A torch rewrite of the port's ``src/repro_torch/data/synthetic.py``
(``pmu_magnitude``, ``pmu_angle``) with ``chip_smoke.py:make_traffic``'s
per-channel templates: row r takes template r % len(templates).

* ``pmu_magnitude``: level + N(0, noise), plus level shifts (each adds
  N(0, 4 noise) from a uniform position on) and brief tap changes
  (+-tap_step for tap_len samples); event counts are per ``ref_samples``
  and scale with the row length.
* ``pmu_angle``: a ramp of the template's slope a sample plus N(0, noise),
  wrapped into [0, 360).

Every number comes from one ``torch.Generator`` on the device seeded with
the run's seed, drawn in a fixed order in a few large calls, so a seed
gives the same table on every run.
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_table"]

_ROWS_PER_CALL = 128


def _magnitude(torch, p, rows, samples, r0, gen, dev):
    tpl = torch.tensor([p["templates"][(r0 + i) % len(p["templates"])]
                        for i in range(rows)], dtype=torch.float64,
                       device=dev)
    level, noise, tap_step, shifts = (tpl[:, k:k + 1] for k in range(4))
    rate = samples / p["ref_samples"]
    n_shift = torch.round(shifts[:, 0] * rate).to(torch.int64)
    n_taps = round(p["taps_per_ref"] * rate)
    tap_len = int(p["tap_len"])
    x = torch.randn((rows, samples), generator=gen, dtype=torch.float64,
                    device=dev)
    x.mul_(noise).add_(level)
    inc = torch.zeros((rows, samples), dtype=torch.float64, device=dev)
    k = int(n_shift.max())
    if k:
        pos = torch.randint(0, max(samples - 1, 1), (rows, k), generator=gen,
                            device=dev)
        amt = torch.randn((rows, k), generator=gen, dtype=torch.float64,
                          device=dev) * (4.0 * noise)
        amt = amt * (torch.arange(k, device=dev)[None, :] < n_shift[:, None])
        inc.scatter_add_(1, pos, amt)
    if n_taps:
        pos = torch.randint(0, max(samples - tap_len - 1, 1), (rows, n_taps),
                            generator=gen, device=dev)
        sign = torch.randint(0, 2, (rows, n_taps), generator=gen,
                             device=dev).to(torch.float64) * 2.0 - 1.0
        step = sign * tap_step
        inc.scatter_add_(1, pos, step)
        inc.scatter_add_(1, pos + tap_len, -step)
    return x.add_(torch.cumsum(inc, dim=1))


def _angle(torch, p, rows, samples, r0, gen, dev):
    tpl = torch.tensor([p["templates"][(r0 + i) % len(p["templates"])]
                        for i in range(rows)], dtype=torch.float64,
                       device=dev)
    slope, noise = tpl[:, 0:1], tpl[:, 1:2]
    t = torch.arange(samples, dtype=torch.float64, device=dev)[None, :]
    x = torch.randn((rows, samples), generator=gen, dtype=torch.float64,
                    device=dev)
    return torch.remainder(t * slope + x * noise, 360.0)


_SIGNALS = {"pmu_magnitude": _magnitude, "pmu_angle": _angle}


def make_table(torch, signal: dict, rows: int, samples: int, seed: int,
               device) -> np.ndarray:
    """``rows`` x ``samples`` float64 of the configuration's ``signal``
    (its ``kind`` and template parameters) from ``seed``, made on
    ``device`` ``_ROWS_PER_CALL`` rows at a time and returned in host
    memory."""
    make = _SIGNALS[signal["kind"]]
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    out = torch.empty((rows, samples), dtype=torch.float64)
    for r0 in range(0, rows, _ROWS_PER_CALL):
        r1 = min(rows, r0 + _ROWS_PER_CALL)
        out[r0:r1].copy_(make(torch, signal, r1 - r0, samples, r0, gen, dev))
    return out.numpy()
