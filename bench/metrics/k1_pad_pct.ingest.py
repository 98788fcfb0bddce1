"""k1_pad_pct.ingest (%, layer: K1, program counter): the share of the
coalescer's padded scan cells that hold no block: the program's
``repro_encode_flush_cells_total`` (slots x padded blocks a flush) less
the real blocks (``repro_encode_flush_blocks``' sum), over the cells.
Read from a traced run on the card alone (a device trace present), as
the idle split it refines; ``None`` without its keys."""

CELLS = "repro_encode_flush_cells_total"
BLOCKS = "repro_encode_flush_blocks.sum"


def read(r):
    cells = r.registry_delta.get(CELLS)
    if not r.device_events or not cells or BLOCKS not in r.registry_delta:
        return None
    return 100.0 * (cells - r.registry_delta[BLOCKS]) / cells
