"""flush_wait_share.ingest (%, layer: coalescer and encoder, program
span): the coalescer flushes' ``h2d``, ``scan`` and ``d2h`` steps (the
program's ``repro_encode_flush_step_seconds``: the batch's copies to the
card, the host's enqueue of the sort and K1, the copy back with the wait
for the card) less the traced run's own capture of K1's inputs, which
runs inside ``scan``, over the window.
Read from a traced run on the card alone (a device trace present), as
the idle split it refines; ``None`` without its keys."""

KEYS = ("repro_encode_flush_step_seconds{step=h2d}.sum",
        "repro_encode_flush_step_seconds{step=scan}.sum",
        "repro_encode_flush_step_seconds{step=d2h}.sum")
CAPTURE = "trace.k1_capture"


def read(r):
    if not r.device_events or not all(k in r.registry_delta for k in KEYS):
        return None
    wait = sum(r.registry_delta[k] for k in KEYS) - r.host_s.get(CAPTURE,
                                                                 0.0)
    return 100.0 * wait / r.window_s
