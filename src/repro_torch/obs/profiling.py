"""Opt-in `torch.profiler` integration.

The counterpart of `repro.obs.profiling`. Host spans (`obs.trace`) say
which phase took how long; this module tags what the card ran inside that
phase, through PyTorch's own profiler. Everything here is a no-op (a
shared null context, or `{}`) unless `enable_profiling()` ran or
`REPRO_TORCH_OBS_PROFILE=1` is set in the environment:

* `step_annotation(step)` — a `torch.profiler.record_function` range
  `train_step#<step>` around each full-data trainer step, so a profile
  groups the card's kernels by optimizer step.
* `annotate(name)` / `named_scope(name)` — a `record_function` range of
  that name (PyTorch runs eagerly, so one mechanism serves both of the
  reference's surfaces).
* `memory_snapshot(tag)` — the CUDA caching allocator's statistics of
  every visible card at a stage boundary, recorded as the gauges
  `mem.<tag>.cuda<i>.bytes_in_use` / `.peak_bytes` and one Chrome counter
  event in the active trace. Without a card it returns `{}`, as the
  reference does on a backend without memory statistics.

`profile_session(logdir)` runs `torch.profiler.profile` (CPU activities,
and CUDA where a card is present) around a whole run and writes a Chrome
trace into `logdir` on exit.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any

import torch

from . import metrics, trace

_ENABLED = False
_NULL = contextlib.nullcontext()


def profiling_enabled() -> bool:
    return _ENABLED


def enable_profiling() -> None:
    global _ENABLED
    _ENABLED = True


def disable_profiling() -> None:
    global _ENABLED
    _ENABLED = False


def step_annotation(step: int):
    """A `train_step#<step>` profiler range around one trainer step."""
    if not _ENABLED:
        return _NULL
    return torch.profiler.record_function(f"train_step#{step}")


def annotate(name: str):
    """A named profiler range (host and card timelines)."""
    if not _ENABLED:
        return _NULL
    return torch.profiler.record_function(name)


def named_scope(name: str):
    """The reference's in-graph name scope; eager PyTorch has no graph, so
    this is the same profiler range as `annotate`."""
    return annotate(name)


def memory_snapshot(tag: str) -> dict[str, Any]:
    """Record the memory statistics of every visible card at a stage boundary.

    Returns {"cuda<i>": bytes_in_use} (empty without a card, or while
    profiling is off). Gauges: `mem.<tag>.cuda<i>.bytes_in_use` and
    `mem.<tag>.cuda<i>.peak_bytes`; also a Chrome counter event `mem.<tag>`
    in any active trace.
    """
    if not _ENABLED or not torch.cuda.is_available():
        return {}
    out: dict[str, Any] = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        in_use = stats.get("allocated_bytes.all.current")
        if in_use is None:
            continue
        label = f"cuda{i}"
        out[label] = int(in_use)
        metrics.gauge(f"mem.{tag}.{label}.bytes_in_use").set(int(in_use))
        peak = stats.get("allocated_bytes.all.peak")
        if peak is not None:
            metrics.gauge(f"mem.{tag}.{label}.peak_bytes").set(int(peak))
    if out:
        trace.counter_event(f"mem.{tag}", **out)
    return out


class profile_session:
    """`with profile_session(logdir): ...` — a `torch.profiler` trace
    around a whole run (kernels on the card's timeline); the Chrome trace
    lands in `logdir/trace.json` on exit (`path` holds it)."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.path = os.path.join(logdir, "trace.json")
        self.prof = None
        self._was_enabled = False

    def __enter__(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._was_enabled = _ENABLED
        enable_profiling()
        self.prof = torch.profiler.profile(activities=activities)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if not self._was_enabled:
            disable_profiling()
        os.makedirs(self.logdir, exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        return False


_env = os.environ.get("REPRO_TORCH_OBS_PROFILE")
if _env and _env not in ("0", "false", "False"):
    enable_profiling()
