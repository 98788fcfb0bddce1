"""ingest_MBps (MB/s, end to end, host clock): f64 bytes fed whose
segments came back, over the window's seconds (all of its rounds, each
ending when its flush returned)."""


def read(r):
    if r.kind != "ingest":
        return None
    return r.bytes_done / r.window_s / 1e6
