"""`repro_torch.obs` — tracing, metrics, profiling and the measurement plane.

The counterpart of `repro.obs`, with its names. Three questions, one
surface: where did a solve spend its wall clock (span tracing ->
`repro_torch.launch.obs_report` per-phase tables), what did it count (the
metrics registry: CG iterations, step modes, autotune hits, sparsity fill,
serve distributions), and what did the card do (the opt-in
`torch.profiler` bridge). Everything here is a no-op on the default path:
tracing off means identity-wrapped functions and zero events, and metrics
touch only host values.

    from repro_torch import obs
    with obs.trace_session("trace.jsonl"):
        fit_exact_gp(...)
    # then: python -m repro_torch.launch.obs_report trace.jsonl --compare-model

The measurement plane: `measure` (measured-vs-modeled per-phase comparison
at the H100's memory bandwidth, and the timed-collective micro-harness),
`health` (solver health events: CG stagnation/divergence/NaN sentinels,
preconditioner staleness, replans), `costmodel` (modeled launches and
bytes per step and phase) and `regress` (noise-aware BENCH-JSON diffing
behind `launch/obs_diff`).

Env knobs: REPRO_TORCH_OBS_TRACE=<path.jsonl> (span tracing),
REPRO_TORCH_OBS_PROFILE=1 (profiler ranges + memory gauges),
REPRO_TORCH_OBS_HEALTH=<path.jsonl> (the solver health-event sink).
"""

from . import health
from . import measure
from . import regress
from .costmodel import (
    CollectiveCost,
    StepCost,
    dist_collective_cost,
    mll_phase_costs,
    mll_step_cost,
)
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    SLOTracker,
    SpanTotal,
    counter,
    gauge,
    histogram,
    latency_summary,
    record_solver_step,
    registry,
    slo,
)
from .profiling import (
    annotate,
    disable_profiling,
    enable_profiling,
    memory_snapshot,
    named_scope,
    profile_session,
    profiling_enabled,
    step_annotation,
)
from .trace import (
    clock_us,
    complete_event,
    counter_event,
    disable_tracing,
    drain_events,
    enable_tracing,
    host_span,
    instant,
    maybe_wrap,
    next_request_id,
    read_span,
    span,
    trace_session,
    tracing_enabled,
)

__all__ = [
    "health", "measure", "regress",
    "CollectiveCost", "StepCost", "dist_collective_cost",
    "mll_phase_costs", "mll_step_cost",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "SLOTracker",
    "SpanTotal",
    "counter", "gauge", "histogram", "latency_summary",
    "record_solver_step", "registry", "slo",
    "annotate", "disable_profiling", "enable_profiling", "memory_snapshot",
    "named_scope", "profile_session", "profiling_enabled", "step_annotation",
    "clock_us", "complete_event", "counter_event", "disable_tracing",
    "drain_events", "enable_tracing", "host_span", "instant", "maybe_wrap",
    "next_request_id", "read_span", "span", "trace_session",
    "tracing_enabled",
]
