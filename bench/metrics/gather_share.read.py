"""gather_share.read (%, layer: store, program span): the service's
``plan`` and ``gather`` stages (the program's
``repro_serve_stage_seconds`` histogram, the ``serve.plan`` and
``serve.gather`` spans' bodies: seeks, chunk walks through the LRU, byte
gathers and padding) over the window."""

STAGES = ("repro_serve_stage_seconds{stage=plan}.sum",
          "repro_serve_stage_seconds{stage=gather}.sum")


def read(r):
    if not all(k in r.registry_delta for k in STAGES):
        return None
    return 100.0 * sum(r.registry_delta[k] for k in STAGES) / r.window_s
