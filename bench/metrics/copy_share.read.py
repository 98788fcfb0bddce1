"""copy_share.read (%, layer: decode, device trace): the device seconds of
host-to-device and device-to-host copies over the window."""

NAMES = ("Memcpy HtoD", "Memcpy DtoH")


def read(r):
    if not r.device_events:
        return None
    t = r.device_seconds(NAMES)
    return None if t is None else 100.0 * t / r.window_s
