"""Quickstart: compress a power-grid-like stream with IDEALEM, on the card.

The reference's ``examples/quickstart.py`` on the PyTorch + CUDA port: the
encode scan runs K1 (``csrc/encode_step.cu``) and the decode the device
reconstruction; ``--device cpu`` runs the plain PyTorch versions instead.

  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import IdealemCodec, quality_measures, \
    spectral_band_error
from repro_torch.data import synthetic
from repro_torch.device import resolve_device


def codec(device, **kw) -> IdealemCodec:
    """A codec on ``device``: the hand-written kernels on the card, the
    plain ``torch`` scan and decode on the host."""
    backend = "cuda" if device.type == "cuda" else "torch"
    return IdealemCodec(backend=backend, decode_backend=backend,
                        device=str(device), **kw)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    n = 64 * 2048
    mag = synthetic.pmu_magnitude(n, seed=7)         # stationary + tap changes
    ang = synthetic.pmu_angle(n, seed=7)             # wrapping ramp [0,360)

    # --- standard mode on magnitude data (paper Table I: B=32, D=255) ---
    c = codec(dev, mode="std", block_size=32, num_dict=255, alpha=0.01,
              rel_tol=0.5)
    blob = c.encode(mag)
    recon = c.decode(blob)
    print(f"[std]      ratio={c.compression_ratio(mag, blob):8.2f}  "
          f"(limit {8 * 32})")
    q0, q1 = quality_measures(mag), quality_measures(recon)
    print(f"           peaks {q0['m1_num_peaks']:.0f} -> "
          f"{q1['m1_num_peaks']:.0f}, outliers "
          f"{q0['m6_pct_outliers']:.2f}% -> {q1['m6_pct_outliers']:.2f}%")
    print(f"           spectra: {spectral_band_error(mag, recon)}")

    # --- residual mode on phase angles (B=112, bounded range) ---
    c = codec(dev, mode="residual", block_size=112, num_dict=255,
              alpha=0.01, rel_tol=0.5, value_range=(0.0, 360.0))
    blob = c.encode(ang)
    recon = c.decode(blob)
    err = np.abs(recon - ang)
    circ = np.minimum(err, 360.0 - err)
    print(f"[residual] ratio={c.compression_ratio(ang, blob):8.2f}  "
          f"(limit {8 * 112 / 9:.2f})")
    print(f"           circular err p95 = {np.percentile(circ, 95):.3f} deg")

    # --- min/max check preserves brief tap changes (paper Sec. VII-D) ---
    with_mm = codec(dev, mode="std", block_size=32, num_dict=255,
                    alpha=0.01, rel_tol=0.3)
    without = codec(dev, mode="std", block_size=32, num_dict=255,
                    alpha=0.01, use_minmax=False)

    def jumps(x):
        return quality_measures(x)["m5_num_big_jumps"]
    y_mm = with_mm.decode(with_mm.encode(mag))
    y_no = without.decode(without.encode(mag))
    print(f"[minmax]   big jumps: orig={jumps(mag):.0f} "
          f"with={jumps(y_mm):.0f} without={jumps(y_no):.0f}")


if __name__ == "__main__":
    main()
