"""`repro_torch.obs` — metrics and span tracing for the port's serve path.

The counterpart of the reference's `repro.obs.metrics` and
`repro.obs.trace` (both host-side, stdlib and numpy only): counters,
gauges, histograms and per-model SLO trackers in one process-global
registry, and Chrome-trace JSONL spans that are a no-op while tracing is
off.

    from repro_torch import obs
    with obs.trace_session("trace.jsonl"):
        ...
    obs.registry().snapshot()
"""

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    SLOTracker,
    counter,
    gauge,
    histogram,
    latency_summary,
    registry,
    slo,
)
from .trace import (
    complete_event,
    disable_tracing,
    drain_events,
    enable_tracing,
    instant,
    next_request_id,
    span,
    trace_session,
    tracing_enabled,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "SLOTracker",
    "counter", "gauge", "histogram", "latency_summary", "registry", "slo",
    "complete_event", "disable_tracing", "drain_events", "enable_tracing",
    "instant", "next_request_id", "span", "trace_session", "tracing_enabled",
]
