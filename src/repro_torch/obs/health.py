"""Solver health events: structured JSONL sentinels for sick solves.

The counterpart of `repro.obs.health`, with its event kinds, severities,
thresholds and JSONL format. The BBMM training loop can fail quietly: CG
runs its full iteration budget without converging, the residual stagnates
against a stale preconditioner, bf16 compute overflows into NaN, or the
blocksparse plan drifts out of date, and the optimizer keeps stepping on
bad gradients. This module turns those conditions into events.

* **Events** are JSON objects `{ts, kind, severity, ...fields}` written as
  JSONL to a sink file (`REPRO_TORCH_OBS_HEALTH=path` or
  `enable_health(path)`), buffered in memory when no path is given
  (`drain_health_events`).
* **Counters always fire**: every event bumps `health.<kind>` in the
  metrics registry even when the sink is off.
* **Trace mirror**: when tracing is on, each event also lands as an
  instant marker in the trace JSONL. `obs_report --health` summarizes the
  sink.
* Every check runs on values already on the host, after the step's last
  kernel has finished: residual trajectories come back in
  `PCGResult.residuals` (`track_residuals=True`, which the engines request
  only while the sink is on).

Event kinds:

  cg.nan          non-finite residual/solution — the step's gradients are
                  garbage (severity=error)
  cg.max_iters    CG ran max_iters iterations with rel > tol
  cg.divergence   residual grew over the trajectory (late >> early)
  cg.stagnation   windowed improvement ratio ~1 while unconverged —
                  the stale-preconditioner signature
  precond.stale   drift exceeded the refresh threshold (refresh imminent)
  precond.refresh preconditioner rebuilt (mode != warm)
  sparse.replan   blocksparse plan rebuilt mid-fit (drift-triggered)
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

import numpy as np

from . import metrics as _metrics
from . import trace as _trace

# stagnation check: over the trailing window of active iterations, demand
# at least this much residual decay — a ratio above ~0.95 per WINDOW steps
# means CG is treading water (a healthy preconditioned solve contracts
# geometrically per iteration, not per ten)
STAGNATION_WINDOW = 10
STAGNATION_RATIO = 0.95
# divergence: final residual this much above the trajectory's minimum
DIVERGENCE_RATIO = 10.0


class _HealthState:
    def __init__(self):
        self.enabled = False
        self.path: str | None = None
        self.events: list[dict] = []
        self.lock = threading.Lock()
        self._file = None


_STATE = _HealthState()


def health_enabled() -> bool:
    return _STATE.enabled


def enable_health(path: str | None = None) -> None:
    """Turn the event sink on. `path` streams JSONL; None buffers in
    memory (`drain_health_events`)."""
    st = _STATE
    with st.lock:
        if st._file is not None:
            st._file.close()
            st._file = None
        st.path = path
        st.events = []
        if path is not None:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            st._file = open(path, "w")
        st.enabled = True


def disable_health() -> str | None:
    st = _STATE
    with st.lock:
        st.enabled = False
        if st._file is not None:
            st._file.close()
            st._file = None
    return st.path


def drain_health_events() -> list[dict]:
    st = _STATE
    with st.lock:
        ev, st.events = st.events, []
        return ev


def emit(kind: str, severity: str = "warn", **fields: Any) -> None:
    """Record one health event: registry counter (always), sink JSONL and
    trace instant (when the respective sinks are enabled)."""
    _metrics.counter(f"health.{kind}").inc()
    _trace.instant(f"health.{kind}", severity=severity, **fields)
    st = _STATE
    if not st.enabled:
        return
    event = {"ts": time.time(), "kind": kind, "severity": severity}
    event.update(fields)
    with st.lock:
        if not st.enabled:
            return
        if st._file is not None:
            st._file.write(json.dumps(event) + "\n")
            st._file.flush()
        else:
            st.events.append(event)


def check_solver_step(*, step: int, mode: str, tol: float, max_iters: int,
                      iters_per_rhs, rel_residual, residuals=None,
                      drift: float | None = None) -> list[str]:
    """Run every per-step sentinel on one solve's host-concrete aux.

    iters_per_rhs / rel_residual: MLLAux.cg_iterations / .rel_residual, on
    the host. residuals: optional (max_iters, t) per-iteration
    relative-residual trajectory (MLLAux.residuals with
    track_residuals=True) — the stagnation/divergence checks need it; the
    NaN/max_iters checks do not.
    Returns the list of event kinds emitted (possibly empty).
    """
    emitted: list[str] = []
    iters = np.asarray(iters_per_rhs).ravel()
    rel = np.asarray(rel_residual, dtype=np.float64).ravel()

    if not np.all(np.isfinite(rel)):
        bad = [int(i) for i in np.flatnonzero(~np.isfinite(rel))]
        emit("cg.nan", severity="error", step=step, mode=mode, columns=bad)
        emitted.append("cg.nan")
        return emitted  # the trajectory checks below would only re-trip

    unconverged = (iters >= max_iters) & (rel > tol)
    if np.any(unconverged):
        cols = [int(i) for i in np.flatnonzero(unconverged)]
        emit("cg.max_iters", step=step, mode=mode, columns=cols,
             max_iters=int(max_iters),
             worst_rel=float(rel[unconverged].max()), tol=float(tol))
        emitted.append("cg.max_iters")

    if residuals is not None:
        traj = np.asarray(residuals, dtype=np.float64)  # (m, t)
        for col in range(traj.shape[1]):
            m = int(iters[col]) if col < iters.size else traj.shape[0]
            active = traj[:max(m, 1), col]
            active = active[np.isfinite(active)]
            if active.size < 2 or rel[col] <= tol:
                continue
            if active[-1] > DIVERGENCE_RATIO * max(active.min(), 1e-300):
                emit("cg.divergence", severity="error", step=step, mode=mode,
                     column=int(col), final_rel=float(active[-1]),
                     min_rel=float(active.min()))
                emitted.append("cg.divergence")
            elif active.size > STAGNATION_WINDOW:
                window = active[-STAGNATION_WINDOW:]
                ratio = window[-1] / max(window[0], 1e-300)
                if ratio > STAGNATION_RATIO:
                    emit("cg.stagnation", step=step, mode=mode,
                         column=int(col), window=STAGNATION_WINDOW,
                         improvement_ratio=float(ratio),
                         rel=float(rel[col]))
                    emitted.append("cg.stagnation")

    if drift is not None and mode != "warm":
        emit("precond.refresh", severity="info", step=step, mode=mode,
             drift=float(drift))
        emitted.append("precond.refresh")
    return emitted


def precond_stale(*, step: int, drift: float, threshold: float) -> None:
    """Drift crossed the refresh threshold — the next step refreshes."""
    emit("precond.stale", step=step, drift=float(drift),
         threshold=float(threshold))


def sparse_replan(*, step: int, fill_before: float | None = None,
                  fill_after: float | None = None) -> None:
    """The blocksparse plan was rebuilt mid-fit (drift-triggered)."""
    fields: dict[str, Any] = {"step": step}
    if fill_before is not None:
        fields["fill_before"] = float(fill_before)
    if fill_after is not None:
        fields["fill_after"] = float(fill_after)
    emit("sparse.replan", severity="info", **fields)


def load_health(path: str) -> list[dict]:
    """Read a health JSONL file, skipping truncated/garbled lines (a
    process may have died mid-write)."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(ev, dict) and "kind" in ev:
                events.append(ev)
    return events


# REPRO_TORCH_OBS_HEALTH=path turns the sink on for any entry point, as
# REPRO_TORCH_OBS_TRACE does tracing
_env_path = os.environ.get("REPRO_TORCH_OBS_HEALTH")
if _env_path:
    enable_health(_env_path)


def summarize_health(events: list[dict]) -> dict:
    """Per-kind counts + the worst severity + last event, for obs_report."""
    order = {"info": 0, "warn": 1, "error": 2}
    by_kind: dict[str, dict] = {}
    for ev in events:
        kind = ev.get("kind", "?")
        slot = by_kind.setdefault(
            kind, {"count": 0, "severity": "info", "last": None})
        slot["count"] += 1
        sev = ev.get("severity", "warn")
        if order.get(sev, 1) > order.get(slot["severity"], 0):
            slot["severity"] = sev
        slot["last"] = ev
    return by_kind
