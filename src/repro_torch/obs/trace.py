"""Span-based structured tracing with a no-op disabled path.

The counterpart of `repro.obs.trace`: host-side spans around the phases of
the serve path, emitted as Chrome-trace-event-compatible JSONL (one JSON
object per line; each span a complete "X" event with microsecond ts/dur,
pid/tid and an `args` dict), the format the reference's `obs_report`
reads.

* Disabled by default. `span()` with tracing off returns a shared no-op
  singleton: no allocation, no clock read, no lock.
* Host-side only. Spans time host wall clock; a span around work on the
  card measures the enqueue unless the caller synchronizes inside it.
* Request flows that hop threads (caller -> assembler -> worker) are
  emitted after the fact with `complete_event` on a synthetic per-request
  tid, so ts/dur containment rebuilds each request's stack.

Enable with `enable_tracing(path)` / `trace_session(path)`, or for any
entry point through the environment: `REPRO_TORCH_OBS_TRACE=<path.jsonl>`
turns tracing on at import, with a flush at exit and on SIGINT/SIGTERM.
`disable_tracing()` appends a final metrics-registry snapshot event, so
one file carries spans and counters.
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import signal
import threading
import time
from typing import Any


def _now_us() -> float:
    return time.perf_counter_ns() / 1e3


class _TraceState:
    """Process-global sink. `enabled` is the only thing the fast path reads."""

    def __init__(self):
        self.enabled = False
        self.path: str | None = None
        self.events: list[dict] = []     # buffered events (in-memory mode)
        self.lock = threading.Lock()
        self._file = None
        self._atexit_registered = False
        self._signals_hooked = False
        self._prev_handlers: dict[int, Any] = {}


_STATE = _TraceState()


class _NullSpan:
    """The disabled-mode span: a reusable, stateless no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):  # matches _Span.set
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """An open span; emits one complete event on exit."""

    __slots__ = ("name", "args", "_t0")

    def __init__(self, name: str, args: dict):
        self.name = name
        self.args = args
        self._t0 = _now_us()

    def set(self, **attrs) -> "_Span":
        """Attach attributes known only mid-span."""
        self.args.update(attrs)
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _now_us()
        _emit({"name": self.name, "ph": "X", "ts": self._t0,
               "dur": t1 - self._t0, "pid": os.getpid(),
               "tid": threading.get_ident(), "args": self.args})
        return False


def _emit(event: dict) -> None:
    st = _STATE
    with st.lock:
        if not st.enabled:
            return
        if st._file is not None:
            st._file.write(json.dumps(event) + "\n")
        else:
            st.events.append(event)


def tracing_enabled() -> bool:
    return _STATE.enabled


def span(name: str, **attrs: Any):
    """Context manager timing a named phase; a no-op singleton when
    disabled. `with span("fleet_observe", m=64) as sp: ...; sp.set(k=v)`."""
    if not _STATE.enabled:
        return _NULL_SPAN
    return _Span(name, attrs)


def instant(name: str, **attrs: Any) -> None:
    """A zero-duration marker event (Chrome "i" phase)."""
    if not _STATE.enabled:
        return
    _emit({"name": name, "ph": "i", "ts": _now_us(), "s": "t",
           "pid": os.getpid(), "tid": threading.get_ident(), "args": attrs})


def counter_event(name: str, **values: float) -> None:
    """A Chrome counter ("C") sample, e.g. device memory at a boundary."""
    if not _STATE.enabled:
        return
    _emit({"name": name, "ph": "C", "ts": _now_us(), "pid": os.getpid(),
           "args": values})


def complete_event(name: str, ts_us: float, dur_us: float,
                   tid: int | str | None = None, **attrs: Any) -> None:
    """Emit a complete ("X") event from recorded timestamps, on `tid` (a
    synthetic per-request tid for flows that hop threads; None = the
    calling thread)."""
    if not _STATE.enabled:
        return
    _emit({"name": name, "ph": "X", "ts": ts_us, "dur": dur_us,
           "pid": os.getpid(),
           "tid": threading.get_ident() if tid is None else tid,
           "args": attrs})


_REQUEST_IDS = itertools.count(1)


def next_request_id() -> str:
    """A process-unique serve request ID ("r1", "r2", ...)."""
    return f"r{next(_REQUEST_IDS)}"


def maybe_wrap(name: str, fn):
    """Span-wrap `fn`; `fn` itself when tracing is off at wrap time, so an
    instrumented call site costs nothing by default."""
    if not _STATE.enabled:
        return fn

    def wrapped(*a, **kw):
        with span(name):
            return fn(*a, **kw)

    wrapped.__name__ = getattr(fn, "__name__", name)
    wrapped.__wrapped__ = fn
    return wrapped


def enable_tracing(path: str | None = None) -> None:
    """Turn the sink on. `path` streams JSONL lines to a file (parent dirs
    created); None buffers events in memory (`drain_events`)."""
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
        if not st._atexit_registered:
            atexit.register(_atexit_flush)
            st._atexit_registered = True
    _hook_signals()


def disable_tracing(snapshot_metrics: bool = True) -> str | None:
    """Flush and close the sink; returns the trace path (None in memory
    mode). Appends a final `repro.metrics` metadata event holding the
    metrics-registry snapshot."""
    st = _STATE
    if not st.enabled:
        return st.path
    if snapshot_metrics:
        from . import metrics as _metrics  # local: avoid an import cycle

        snap = _metrics.registry().snapshot()
        if snap:
            _emit({"name": "repro.metrics", "ph": "M", "ts": _now_us(),
                   "pid": os.getpid(), "args": snap})
    with st.lock:
        st.enabled = False
        if st._file is not None:
            st._file.close()
            st._file = None
    return st.path


def drain_events() -> list[dict]:
    """Memory-mode accessor: pop and return all buffered events."""
    st = _STATE
    with st.lock:
        ev, st.events = st.events, []
        return ev


class trace_session:
    """`with trace_session(path): ...` — enable, run, flush and close."""

    def __init__(self, path: str | None):
        self.path = path

    def __enter__(self):
        enable_tracing(self.path)
        return self

    def __exit__(self, *exc):
        disable_tracing()
        return False


def _atexit_flush() -> None:
    try:
        disable_tracing()
    except (OSError, ValueError):  # a sink already closed under us
        pass


def _signal_flush(signum, frame) -> None:
    """Flush the sink, then defer to the handler installed before (atexit
    does not run when a process dies on an unhandled SIGTERM)."""
    _atexit_flush()
    prev = _STATE._prev_handlers.get(signum)
    if callable(prev):
        prev(signum, frame)
    else:
        signal.signal(signum, signal.SIG_DFL)
        signal.raise_signal(signum)


def _hook_signals() -> None:
    """Flushing SIGINT/SIGTERM handlers chained onto the existing ones;
    only possible from the main thread (atexit covers the others)."""
    st = _STATE
    if st._signals_hooked:
        return
    try:
        for signum in (signal.SIGINT, signal.SIGTERM):
            st._prev_handlers[signum] = signal.signal(signum, _signal_flush)
        st._signals_hooked = True
    except ValueError:
        pass


_env_path = os.environ.get("REPRO_TORCH_OBS_TRACE")
if _env_path:
    enable_tracing(_env_path)
