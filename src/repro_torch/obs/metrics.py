"""Metrics registry: counters, gauges, histograms and per-model SLO trackers.

The counterpart of `repro.obs.metrics`, with the same instruments, names
and summaries. A process-global registry of cheap host-side instruments:
every record is one lock and an arithmetic operation per batch, request or
solve, never per element and never between kernel launches. Values that
live on the card (CG iterations, residuals) are recorded after the caller
has brought them to the host.

Instrument names are dotted lowercase, subsystem first (`cg.iters`,
`solver.steps.warm`, `sparse.fill`, `serve.batch_rows`,
`serve.slo.<model>`; `span.<name>`, the window totals that `obs.trace`
keeps of each traced span). `snapshot()` returns a plain-JSON dict keyed by
those names (histograms summarize to count/mean/percentiles).
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np


class Counter:
    """Monotonic accumulator."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    @property
    def value(self):
        return self._value

    def reset(self):
        with self._lock:
            self._value = 0

    def snapshot(self):
        return self._value


class Gauge:
    """Last-write-wins sample (fill ratios, queue depths, memory bytes)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = None
        self._lock = threading.Lock()

    def set(self, value):
        with self._lock:
            self._value = value

    @property
    def value(self):
        return self._value

    def reset(self):
        with self._lock:
            self._value = None

    def snapshot(self):
        return self._value


class Histogram:
    """Raw-sample histogram with percentile summaries.

    Stores samples exactly up to `max_samples`, then keeps every other
    sample and doubles the stride: a deterministic reservoir that keeps the
    order statistics of per-batch and per-request observations.
    """

    __slots__ = ("name", "_samples", "_stride", "_seen", "_sum", "_lock",
                 "max_samples")

    def __init__(self, name: str, max_samples: int = 65536):
        self.name = name
        self.max_samples = max_samples
        self._samples: list[float] = []
        self._stride = 1
        self._seen = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, value) -> None:
        with self._lock:
            v = float(value)
            self._sum += v
            if self._seen % self._stride == 0:
                self._samples.append(v)
                if len(self._samples) >= self.max_samples:
                    self._samples = self._samples[::2]
                    self._stride *= 2
            self._seen += 1

    def observe_many(self, values) -> None:
        for v in np.asarray(values).ravel():
            self.observe(v)

    @property
    def count(self) -> int:
        return self._seen

    @property
    def sum(self) -> float:
        return self._sum

    def percentiles(self, qs=(50, 99)):
        with self._lock:
            if not self._samples:
                return tuple(float("nan") for _ in qs)
            arr = np.asarray(self._samples)
        return tuple(float(np.percentile(arr, q)) for q in qs)

    def reset(self):
        with self._lock:
            self._samples = []
            self._stride = 1
            self._seen = 0
            self._sum = 0.0

    def summary(self) -> dict:
        p50, p90, p99 = self.percentiles((50, 90, 99))
        mx = max(self._samples) if self._samples else float("nan")
        return {
            "count": self._seen,
            "sum": self._sum,
            "mean": self._sum / self._seen if self._seen else float("nan"),
            "p50": p50,
            "p90": p90,
            "p99": p99,
            "max": mx,
        }

    def snapshot(self):
        return self.summary()


class SpanTotal:
    """Totals of one span name over a traced window: how many closed, their
    summed duration and self time (the duration less what direct children
    cover), in ms. `kind` is the span's declaration (`obs.trace`): "host"
    (host-only work), "read" (a read from the card) or "plain"."""

    __slots__ = ("name", "kind", "count", "total_ms", "self_ms", "_lock")

    def __init__(self, name: str, kind: str = "plain"):
        self.name = name
        self.kind = kind
        self.count = 0
        self.total_ms = 0.0
        self.self_ms = 0.0
        self._lock = threading.Lock()

    def record(self, dur_ms: float, self_ms: float) -> None:
        with self._lock:
            self.count += 1
            self.total_ms += dur_ms
            self.self_ms += self_ms

    def reset(self):
        with self._lock:
            self.count = 0
            self.total_ms = 0.0
            self.self_ms = 0.0

    def snapshot(self):
        return {"kind": self.kind, "count": self.count,
                "total_ms": self.total_ms, "self_ms": self.self_ms}


class SLOTracker:
    """Per-model serving SLO instrument: latency percentiles and windowed QPS.

    One per resident model of the serve fleet (`serve.slo.<model>`). Each
    completed request records (latency, rows); `summary()` reports p50/p99
    latency in ms over all samples and QPS over the trailing `window_s`
    seconds. The timestamp deque is pruned on both record and summary, so a
    read after traffic stops sees QPS decay to zero and memory stays
    O(recent QPS).

    With `target_ms` set, every request over the target counts as a breach,
    and `summary()` reports the lifetime breach count and `burn_rate` (the
    breached fraction).
    """

    __slots__ = ("name", "window_s", "target_ms", "_lat", "_times", "_rows",
                 "_breaches", "_lock")

    def __init__(self, name: str, window_s: float = 60.0,
                 target_ms: float | None = None):
        self.name = name
        self.window_s = float(window_s)
        self.target_ms = target_ms
        self._lat = Histogram(name + ".latency_ms")
        self._times: collections.deque = collections.deque()
        self._rows = 0
        self._breaches = 0
        self._lock = threading.Lock()

    def _prune_locked(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._times and self._times[0] < cutoff:
            self._times.popleft()

    def record(self, latency_s: float, rows: int = 1,
               now: float | None = None) -> bool:
        """Record one request; returns True when it breached `target_ms`."""
        now = time.monotonic() if now is None else now
        lat_ms = latency_s * 1e3
        self._lat.observe(lat_ms)
        breached = self.target_ms is not None and lat_ms > self.target_ms
        with self._lock:
            self._rows += int(rows)
            if breached:
                self._breaches += 1
            self._times.append(now)
            self._prune_locked(now)
        return breached

    @property
    def count(self) -> int:
        return self._lat.count

    def summary(self, now: float | None = None) -> dict:
        now = time.monotonic() if now is None else now
        p50, p99 = self._lat.percentiles((50, 99))
        with self._lock:
            self._prune_locked(now)
            in_window = len(self._times)
            # span since the oldest in-window request, so a model that has
            # served for a few seconds only is not diluted by the window
            span = max(now - self._times[0], 1e-9) if self._times else None
            rows = self._rows
            breaches = self._breaches
        out = {
            "count": self._lat.count,
            "rows": rows,
            "p50_ms": p50,
            "p99_ms": p99,
            "qps": (in_window / span) if span else 0.0,
        }
        if self.target_ms is not None:
            out["target_ms"] = self.target_ms
            out["breaches"] = breaches
            out["burn_rate"] = breaches / max(self._lat.count, 1)
        return out

    def reset(self) -> None:
        self._lat.reset()
        with self._lock:
            self._times.clear()
            self._rows = 0
            self._breaches = 0

    def snapshot(self):
        return self.summary()


class MetricsRegistry:
    """Name -> instrument map; `counter`/`gauge`/`histogram`/`slo` are
    get-or-create, so call sites never coordinate."""

    def __init__(self):
        self._instruments: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def slo(self, name: str) -> SLOTracker:
        return self._get(name, SLOTracker)

    def span_total(self, name: str, kind: str = "plain") -> SpanTotal:
        """The totals of span `name`, kept as `span.<name>`."""
        inst = self._get(f"span.{name}", SpanTotal)
        inst.kind = kind
        return inst

    def snapshot(self) -> dict:
        """Plain-JSON view of every instrument (sorted by name)."""
        with self._lock:
            items = sorted(self._instruments.items())
        return {name: inst.snapshot() for name, inst in items}

    def reset(self, prefix: str = "") -> None:
        """Zero every instrument whose name starts with `prefix`."""
        with self._lock:
            items = list(self._instruments.values())
        for inst in items:
            if inst.name.startswith(prefix):
                inst.reset()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return _REGISTRY.histogram(name)


def slo(name: str) -> SLOTracker:
    return _REGISTRY.slo(name)


def latency_summary(latencies_s, wall_s: float | None = None) -> dict:
    """p50/p99/QPS of a request set, as the serve launcher prints it.

    latencies_s: per-request wall seconds; wall_s: total elapsed seconds of
    the set (the QPS denominator; omit to skip qps). Below 100 samples
    np.percentile's p99 interpolates between order statistics — a latency
    no request saw — so `p99_interpolated` flags it and `max_ms` gives the
    honest tail.
    """
    lats = np.asarray(latencies_s, dtype=np.float64)
    if lats.size == 0:
        return {"count": 0, "p50_ms": float("nan"), "p99_ms": float("nan"),
                "mean_ms": float("nan"), "max_ms": float("nan"),
                "p99_interpolated": True, "qps": float("nan")}
    p50, p99 = np.percentile(lats, (50, 99)) * 1e3
    return {
        "count": int(lats.size),
        "p50_ms": float(p50),
        "p99_ms": float(p99),
        "mean_ms": float(lats.mean() * 1e3),
        "max_ms": float(lats.max() * 1e3),
        "p99_interpolated": bool(lats.size < 100),
        "qps": float(lats.size / wall_s) if wall_s else float("nan"),
    }


def record_solver_step(*, mode: str, iters_per_rhs, drift: float,
                       seconds: float, launches: int | None = None,
                       hbm_bytes: float | None = None,
                       phase_ms: dict | None = None,
                       reg: MetricsRegistry | None = None) -> dict:
    """Record one MLL solver step into the registry and return its telemetry
    record (a `GPFitResult.telemetry` entry), as the reference's.

    iters_per_rhs: the per-column iteration counts of the solve (already on
    the host). launches / hbm_bytes: the cost model's price of the step.
    phase_ms: measured wall ms per phase of the phased dispatch
    (`{"precond_build": .., "cg_solve": .., ...}`); lands in the
    `phase.<name>_ms` histograms and the record, the measured half that
    `obs_report --compare-model` sets against the byte model.
    """
    r = reg if reg is not None else _REGISTRY
    iters = np.asarray(iters_per_rhs).ravel()
    total = int(iters.sum())
    r.counter(f"solver.steps.{mode}").inc()
    r.counter("cg.iters").inc(total)
    h = r.histogram("cg.iters_per_rhs")
    for it in iters:
        h.observe(int(it))
    r.histogram("solver.step_seconds").observe(seconds)
    entry = {
        "mode": mode,
        "refreshed": mode != "warm",
        "cg_iters": total,
        "cg_iters_per_rhs": [int(i) for i in iters],
        "drift": drift,
        "seconds": seconds,
    }
    if launches is not None:
        r.counter("mvm.matmat_launches").inc(int(launches))
        entry["mvm_launches"] = int(launches)
    if hbm_bytes is not None:
        r.counter("mvm.hbm_bytes_modeled").inc(float(hbm_bytes))
        entry["hbm_bytes_modeled"] = float(hbm_bytes)
    if phase_ms is not None:
        for phase, ms in phase_ms.items():
            r.histogram(f"phase.{phase}_ms").observe(float(ms))
        entry["measured_phase_ms"] = {k: float(v)
                                      for k, v in phase_ms.items()}
    return entry
