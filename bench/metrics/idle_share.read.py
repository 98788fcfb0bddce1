"""idle_share.read (%, layer: device, device trace): 1 - the union of
the card's kernel and copy intervals over the traced window."""

from bench.harness.devtrace import union_seconds


def read(r):
    if not r.device_events:
        return None
    lo, hi = r.window
    busy = union_seconds([(a, b) for _, a, b in r.device_events], lo, hi)
    return 100.0 * (1.0 - busy / r.window_s)
