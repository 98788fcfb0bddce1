"""decode_wait_share.read (%, layer: decode, program span): the device
dispatches' ``h2d``, ``launch`` and ``d2h`` steps (the program's
``repro_decode_step_seconds``: the copies to the card, the enqueue of the
gather or K2, the copy back with the wait for the card), over the
window.
Read from a traced run on the card alone (a device trace present), as
the idle split it refines; ``None`` without its keys."""

KEYS = ("repro_decode_step_seconds{step=h2d}.sum",
        "repro_decode_step_seconds{step=launch}.sum",
        "repro_decode_step_seconds{step=d2h}.sum")


def read(r):
    if not r.device_events or not all(k in r.registry_delta for k in KEYS):
        return None
    return 100.0 * sum(r.registry_delta[k] for k in KEYS) / r.window_s
