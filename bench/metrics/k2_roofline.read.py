"""k2_roofline.read (%, layer: K2, device trace): the least time of the
requested rows' sequential cumsum over K2's device time.  The work is the
bytes of the rows the window's requests asked for (not the rows the
decode pads them to): B - 1 f64 values a block, read once and written
once, at HBM3's 3.35 TB/s (NVIDIA H100 SXM data sheet, at the full 700 W;
``device.power_limit_w`` is the card's limit).  The device time sums the
profiler's events of the kernels named below."""

from bench.harness.kwork import HBM_BPS, k2_bytes

KERNELS = ("seq_cumsum_kernel",)


def read(r):
    if r.config.get("mode") != "delta" or not r.requests:
        return None
    t_dev = r.device_seconds(KERNELS)
    if not t_dev:
        return None
    width = int(r.config["block_size"]) - 1
    nbytes = sum(k2_bytes(blocks, width) for _, _, _, blocks in r.requests)
    return 100.0 * nbytes / HBM_BPS / t_dev
