"""read_MBps (MB/s, end to end, host clock): f64 bytes of every window
answered, over the window's seconds (ending when the last pending batch
was answered)."""


def read(r):
    if r.kind != "reads":
        return None
    return r.bytes_done / r.window_s / 1e6
