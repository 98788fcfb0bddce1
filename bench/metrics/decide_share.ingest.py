"""decide_share.ingest (%, layer: coalescer and encoder, program span):
the seconds of the coalescer's flushes (the program's
``repro_encode_flush_seconds`` histogram, which its ``encode.flush``
span encloses) less the sessions' ``prepare`` and ``commit`` inside them
and the traced run's own capture of K1's inputs, over the window: batch
staging, the copies, the sort, K1 and the sync."""

FLUSH = "repro_encode_flush_seconds.sum"
SESSION = ("session.prepare", "session.commit")
CAPTURE = "trace.k1_capture"


def read(r):
    if FLUSH not in r.registry_delta or not all(n in r.host_s
                                                for n in SESSION):
        return None
    flush_s = r.registry_delta[FLUSH]
    inside = sum(r.host_s[n] for n in SESSION) + r.host_s.get(CAPTURE, 0.0)
    return 100.0 * (flush_s - inside) / r.window_s
