"""read_p95_ms.read (ms, layer: service, host clock): the 95th percentile
(nearest rank) of every request answered in the window, from when its
client sent it to when its answer reached the host."""

from bench.harness.core import percentile


def read(r):
    if not r.requests:
        return None
    return 1e3 * percentile([done - due for due, done, _, _ in r.requests],
                            95.0)
