"""decode_pad_pct.read (%, layer: decode, program counter): the share of
the device dispatches' rows that no request asked for: the program's
``repro_decode_rows_total{kind=dispatched}`` (rows after padding requests
to the longest and the dispatch to a power of two) less
``{kind=requested}``, over the dispatched.
Read from a traced run on the card alone (a device trace present), as
the idle split it refines; ``None`` without its keys."""

DISPATCHED = "repro_decode_rows_total{kind=dispatched}"
REQUESTED = "repro_decode_rows_total{kind=requested}"


def read(r):
    sent = r.registry_delta.get(DISPATCHED)
    if not r.device_events or not sent or REQUESTED not in r.registry_delta:
        return None
    return 100.0 * (sent - r.registry_delta[REQUESTED]) / sent
