"""session_share.ingest (%, layer: session, host clock): host seconds in
``IdealemSession.prepare`` and ``commit`` (blocks, transform, segment
assembly), timed by the harness around those calls, over the window."""

NAMES = ("session.prepare", "session.commit")


def read(r):
    if not all(n in r.host_s for n in NAMES):
        return None
    return 100.0 * sum(r.host_s[n] for n in NAMES) / r.window_s
