"""staging_share.ingest (%, layer: coalescer and encoder, program span):
the coalescer flushes' ``take`` and ``stage`` steps (the program's
``repro_encode_flush_step_seconds``: popping and joining the staged
chunks, building the padded batch and its mask on the host), over the
window.
Read from a traced run on the card alone (a device trace present), as
the idle split it refines; ``None`` without its keys."""

KEYS = ("repro_encode_flush_step_seconds{step=take}.sum",
        "repro_encode_flush_step_seconds{step=stage}.sum")


def read(r):
    if not r.device_events or not all(k in r.registry_delta for k in KEYS):
        return None
    return 100.0 * sum(r.registry_delta[k] for k in KEYS) / r.window_s
