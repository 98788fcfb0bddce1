"""prepare_share.ingest (%, layer: session, program span): the coalescer
flushes' ``prepare`` step (the program's
``repro_encode_flush_step_seconds{step=prepare}``, the ``encode.prepare``
span's body: ``IdealemSession.prepare`` over the flush's streams -- tails,
blocks, the transform), over the window.
Read from a traced run on the card alone (a device trace present), as
the idle split it refines; ``None`` without its keys."""

KEY = "repro_encode_flush_step_seconds{step=prepare}.sum"


def read(r):
    if not r.device_events or KEY not in r.registry_delta:
        return None
    return 100.0 * r.registry_delta[KEY] / r.window_s
