"""k1_roofline.ingest (%, layer: K1, device trace): the least time of the
window's K1 work over K1's device time.  The work is reckoned from each
launch's inputs (``harness/kwork.py:k1_flush_work``): the larger of its
bytes at HBM3's 3.35 TB/s and its operations at 67 TFLOP/s float32
(NVIDIA H100 SXM data sheet, dense, at the full 700 W; the result line's
``device.power_limit_w`` is the card's limit).  The device time sums the
profiler's events of the kernels named below."""

from bench.harness.kwork import PEAK_F32, least_seconds

KERNELS = ("encode_scan_kernel",)


def read(r):
    work = r.work.get("encode_scan")
    t_dev = r.device_seconds(KERNELS)
    if not work or not work["launches"] or not t_dev:
        return None
    least, _bound = least_seconds(work["bytes"], work["ops"], PEAK_F32)
    return 100.0 * least / t_dev
