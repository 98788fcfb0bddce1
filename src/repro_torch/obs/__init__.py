"""repro_torch.obs -- the port's telemetry: metrics registry + span tracer.

Dependency-free (stdlib only) so every layer of the port can import it
without cycles: ``core`` and ``store`` write into the process-default
:func:`registry` and :func:`tracer`, and one snapshot sees the whole
port.  The registry is the port's own, separate from the reference
package's; metric names and labels are the reference's.

    from repro_torch import obs

    obs.registry().counter("repro_encode_flushes_total").inc()
    with obs.span("encode.flush", attrs={"streams": 8}):
        ...
    step = obs.registry().histogram("repro_encode_flush_step_seconds",
                                    labels={"step": "stage"})
    with obs.span("encode.stage", seconds=step):   # span + its duration
        ...
    text = obs.to_prometheus()          # Prometheus exposition
    doc = obs.to_json()                 # JSON snapshot (metrics + spans)

``set_enabled(False)`` short-circuits every metric write (span recording
is switched by ``tracer().enabled``; a span's ``seconds=`` histogram
still observes while the tracer is off).
"""
from .metrics import (                                        # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry,
    DEFAULT_LATENCY_BUCKETS, registry, set_enabled,
)
from .trace import Span, SpanTracer, tracer, span, event      # noqa: F401
from .export import (                                         # noqa: F401
    to_prometheus, to_json, parse_prometheus, selfcheck,
    histogram_quantile, quantile, quantile_from_parsed,
    SloSpec, SloResult, evaluate_slos,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS", "registry", "set_enabled",
    "Span", "SpanTracer", "tracer", "span", "event",
    "to_prometheus", "to_json", "parse_prometheus", "selfcheck",
    "histogram_quantile", "quantile", "quantile_from_parsed",
    "SloSpec", "SloResult", "evaluate_slos",
]
