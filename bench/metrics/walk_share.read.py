"""walk_share.read (%, layer: store, program span): the chunk walks'
seconds (the program's ``repro_store_chunk_walk_seconds``, one
observation a walk of a chunk's decision bytes, on the chunk LRU's
misses), over the window.
Read from a traced run on the card alone (a device trace present), as
the idle split it refines; ``None`` without its keys."""

KEY = "repro_store_chunk_walk_seconds.sum"


def read(r):
    if not r.device_events or KEY not in r.registry_delta:
        return None
    return 100.0 * r.registry_delta[KEY] / r.window_s
