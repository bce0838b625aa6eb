"""Span-based structured tracing with a no-op disabled path.

The counterpart of `repro.obs.trace`: host-side spans around the phases of
the serve path, emitted as Chrome-trace-event-compatible JSONL (one JSON
object per line; each span a complete "X" event with microsecond ts/dur,
pid/tid, its `span_id` and `parent_id`, and an `args` dict), the format
the reference's `obs_report` reads.

* Disabled by default. A span with tracing off is a shared no-op
  singleton: no allocation, no clock read, no lock.
* One clock with the profiler. Every event is stamped on the epoch clock
  that `torch.profiler` stamps its own events with (`clock_us`:
  perf_counter plus an offset read at each `enable_tracing`), so the spans
  lie on a device trace of the same run.
* Parent links. Each thread keeps a stack of its open spans; a span's
  parent is the span open on its thread when it entered. Request flows
  that hop threads (caller -> assembler -> worker) are emitted after the
  fact with `complete_event` on a synthetic per-request tid and keep their
  request ID.
* Window totals. Each span that closes while tracing is on adds its
  duration and self time (the duration less what its direct children
  cover) to the registry's `span.<name>` totals (`metrics.SpanTotal`).
  `enable_tracing` resets them and `disable_tracing` keeps them, so its
  closing metrics snapshot carries them.
* Three kinds of span. `span` times host wall clock and may enclose work
  on the card: there it measures the enqueue unless the caller
  synchronizes inside it. `host_span` declares a body that launches
  nothing and copies nothing on the card; under tracing it also opens a
  `torch.profiler` range of its name, so a profile of the run names that
  host time. Only such spans enter the profiler: a range that encloses a
  launch is mirrored onto the card's timeline, where it reads as device
  work. `read_span` declares one read from the card (a copy to the host,
  or an op whose result size the host reads); its totals count the reads.

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

from torch.autograd.profiler import record_function

from . import metrics as _metrics


def _epoch_offset_ns() -> int:
    """The epoch clock (the profiler's) less perf_counter, in ns."""
    a = time.perf_counter_ns()
    wall = time.time_ns()
    b = time.perf_counter_ns()
    return wall - (a + b) // 2


class _TraceState:
    """Process-global sink. `enabled` is the only thing the fast path reads."""

    def __init__(self):
        self.enabled = False
        self.path: str | None = None
        self.events: list[dict] = []     # buffered events (in-memory mode)
        self.lock = threading.Lock()
        self.offset_ns = _epoch_offset_ns()
        self._file = None
        self._atexit_registered = False
        self._signals_hooked = False
        self._prev_handlers: dict[int, Any] = {}


_STATE = _TraceState()
_LOCAL = threading.local()     # .stack: the calling thread's open spans
_SPAN_IDS = itertools.count(1)


def _epoch_us(t_ns: int) -> float:
    """A perf_counter_ns reading on the trace's clock, in whole microseconds:
    epoch-sized stamps keep a quarter microsecond as floats, so a fraction
    could break the nesting of two spans (floor keeps it, exactly)."""
    return float((t_ns + _STATE.offset_ns) // 1000)


def clock_us() -> float:
    """Now on the trace's clock: microseconds since the epoch, as
    `torch.profiler` stamps its events (perf_counter plus the offset read at
    the last `enable_tracing`; differences are perf_counter differences)."""
    return _epoch_us(time.perf_counter_ns())


def _open_spans() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


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
    """An open span; on exit it emits one complete event and adds to its
    name's window totals, if tracing is still on."""

    __slots__ = ("name", "args", "kind", "span_id", "parent", "_t0",
                 "_child_ns", "_range")

    def __init__(self, name: str, args: dict, kind: str = "plain"):
        self.name = name
        self.args = args
        self.kind = kind
        self._range = None

    def set(self, **attrs) -> "_Span":
        """Attach attributes known only mid-span."""
        self.args.update(attrs)
        return self

    def __enter__(self):
        stack = _open_spans()
        self.parent = stack[-1] if stack else None
        self.span_id = next(_SPAN_IDS)
        self._child_ns = 0
        if self.kind == "host":
            self._range = record_function(self.name)
            self._range.__enter__()
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _open_spans().pop()   # spans nest: the top is this one
        dur = t1 - self._t0
        parent = self.parent
        if parent is not None:
            parent._child_ns += dur
        st = _STATE
        if st.enabled:
            _metrics.registry().span_total(self.name, self.kind).record(
                dur / 1e6, (dur - self._child_ns) / 1e6)
            ts = _epoch_us(self._t0)
            _emit({"name": self.name, "ph": "X", "ts": ts,
                   "dur": _epoch_us(t1) - ts,
                   "pid": os.getpid(), "tid": threading.get_ident(),
                   "span_id": self.span_id,
                   "parent_id": None if parent is None else parent.span_id,
                   "args": self.args})
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


def host_span(name: str, **attrs: Any):
    """A span whose body launches nothing and copies nothing on the card;
    under tracing it also opens a `torch.profiler` range of its name."""
    if not _STATE.enabled:
        return _NULL_SPAN
    return _Span(name, attrs, "host")


def read_span(name: str, **attrs: Any):
    """A span around one read from the card; its totals count the reads."""
    if not _STATE.enabled:
        return _NULL_SPAN
    return _Span(name, attrs, "read")


def instant(name: str, **attrs: Any) -> None:
    """A zero-duration marker event (Chrome "i" phase)."""
    if not _STATE.enabled:
        return
    _emit({"name": name, "ph": "i", "ts": clock_us(), "s": "t",
           "pid": os.getpid(), "tid": threading.get_ident(), "args": attrs})


def counter_event(name: str, **values: float) -> None:
    """A Chrome counter ("C") sample, e.g. device memory at a boundary."""
    if not _STATE.enabled:
        return
    _emit({"name": name, "ph": "C", "ts": clock_us(), "pid": os.getpid(),
           "args": values})


def complete_event(name: str, ts_us: float, dur_us: float,
                   tid: int | str | None = None, **attrs: Any) -> None:
    """Emit a complete ("X") event from recorded timestamps (`ts_us` on the
    trace's clock, `clock_us`), on `tid` (a synthetic per-request tid for
    flows that hop threads; None = the calling thread)."""
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
    created); None buffers events in memory (`drain_events`). Reads the
    clock offset anew and zeroes the `span.*` window totals."""
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
        st.offset_ns = _epoch_offset_ns()
        _metrics.registry().reset("span.")
        st.enabled = True
        if not st._atexit_registered:
            atexit.register(_atexit_flush)
            st._atexit_registered = True
    _hook_signals()


def disable_tracing(snapshot_metrics: bool = True) -> str | None:
    """Flush and close the sink; returns the trace path (None in memory
    mode). Appends a final `repro.metrics` metadata event holding the
    metrics-registry snapshot (the `span.*` window totals included, which
    stay in the registry until the next `enable_tracing`)."""
    st = _STATE
    if not st.enabled:
        return st.path
    if snapshot_metrics:
        snap = _metrics.registry().snapshot()
        if snap:
            _emit({"name": "repro.metrics", "ph": "M", "ts": clock_us(),
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
