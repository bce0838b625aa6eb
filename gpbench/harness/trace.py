"""The traced window: `torch.profiler` over the measured window, reduced to
the card's busy time, device time by kernel, the longest idle gaps labelled
by what the host was doing, and a short Chrome trace.

The window is marked by a `gpbench.window` range on the host, so its bounds
are read in the profiler's own clock. Device activity is every CUDA event
the profiler records (kernels, copies, sets), the program's own kernels
launched through ctypes included (CUPTI sees every launch of the process).
"""

from __future__ import annotations

import contextlib
import json
import os

_MARK = "gpbench.window"
_TRACE_EVENTS = 8000       # events kept in the Chrome trace (a few MB)
_NAME = 160                # characters kept of a kernel's name


def _events(prof):
    """(name, is_device, start_us, dur_us) of every recorded event."""
    out = []
    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        raw = None
    if raw is not None:
        for e in raw:
            dev = "cuda" in str(e.device_type()).lower()
            out.append((e.name(), dev, e.start_ns() / 1e3, e.duration_ns() / 1e3))
        return out
    for e in prof.events():
        dev = "cuda" in str(e.device_type).lower()
        out.append((e.name, dev, e.time_range.start, e.time_range.elapsed_us()))
    return out


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_events(events) -> dict:
    """The window's busy and idle time and the breakdown from the events:
    busy_s, window_s, kernel_s {name: s}, device_ops, idle_gaps."""
    marks = [(s, s + d) for n, dev, s, d in events if n == _MARK and not dev]
    if not marks:
        return dict(busy_s=0.0, window_s=0.0, kernel_s={}, device_ops=[],
                    idle_gaps=[])
    w0, w1 = marks[0]
    # (the window's own range is mirrored on the card's timeline as an
    # annotation; it is no device work)
    dev = [(n, max(s, w0), min(s + d, w1)) for n, is_dev, s, d in events
           if is_dev and n != _MARK and s + d > w0 and s < w1]
    kernel_s: dict = {}
    for n, s, e in dev:
        kernel_s[n] = kernel_s.get(n, 0.0) + (e - s) / 1e6
    busy = _merge([(s, e) for _, s, e in dev])
    busy_s = sum(e - s for s, e in busy) / 1e6
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    host = [(n, s, s + d) for n, is_dev, s, d in events
            if not is_dev and n != _MARK and d > 0]
    labelled = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (g0 + g1)
        over = [(e - s, n) for n, s, e in host if s <= mid <= e]
        label = min(over)[1] if over else "host:python"
        labelled.append([label[:_NAME], (g1 - g0) / 1e6])
    ops = [(n[:_NAME], s) for n, s in sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]]
    return dict(busy_s=busy_s, window_s=(w1 - w0) / 1e6, kernel_s=kernel_s,
                device_ops=[list(o) for o in ops], idle_gaps=labelled)


def write_chrome(events, path: str) -> None:
    """The first events of the window as a Chrome trace (host pid 0, card
    pid 1), at most _TRACE_EVENTS of them."""
    evs = sorted(events, key=lambda e: e[2])[:_TRACE_EVENTS]
    out = [{"name": n[:_NAME], "ph": "X", "ts": s, "dur": d, "pid": int(dev), "tid": 0}
           for n, dev, s, d in evs]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": out}, f)


class Session:
    """`with Session(on, chrome_path) as s: <window>`; afterwards `s.result`
    (None when off)."""

    def __init__(self, on: bool, chrome_path: str | None = None):
        self.on, self.chrome_path = on, chrome_path
        self.result = None
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        if not self.on:
            return self
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = self._stack.enter_context(profile(activities=acts))
        self._stack.enter_context(record_function(_MARK))
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._stack.close()
        events = _events(self._prof)
        self.result = reduce_events(events)
        if self.chrome_path:
            write_chrome(events, self.chrome_path)
        return False
