"""perms_share.read (%, layer: decode, program span): the device
dispatches' ``perms`` step (the program's
``repro_decode_step_seconds{step=perms}``, the ``decode.perms`` span's
body: the host's hit permutations, an argsort a hit block), over the
window.
Read from a traced run on the card alone (a device trace present), as
the idle split it refines; ``None`` without its keys."""

KEY = "repro_decode_step_seconds{step=perms}.sum"


def read(r):
    if not r.device_events or KEY not in r.registry_delta:
        return None
    return 100.0 * r.registry_delta[KEY] / r.window_s
