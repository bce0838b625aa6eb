"""The run's context, the clock and the measured window.

Every time is read from `time.perf_counter`; a time that ends device work
is read after `torch.cuda.synchronize()`.
"""

from __future__ import annotations

import time
from typing import NamedTuple


class Context(NamedTuple):
    cell: object          # manifest.Cell
    seed: int
    seconds: float
    trace: bool
    device: str           # "cuda"; "cpu" only in the benchmark's own tests
    t_start: float        # perf_counter at process start
    run_dir: str          # this run's directory inside the checkout
    overrides: dict = {}  # tests: configuration keys replaced (small sizes)
    fault: object = None  # tests: a callable that breaks the timed path
    capture: dict | None = None  # controls: the driver leaves what it judged here

    @property
    def cfg(self) -> dict:
        cfg = dict(self.cell.config)
        for k, v in self.overrides.items():
            cfg[k] = {**cfg[k], **v} if isinstance(v, dict) else v
        return cfg

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


def now() -> float:
    return time.perf_counter()


def sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def free(device) -> None:
    """Return what the process no longer holds to the card."""
    import gc

    import torch

    gc.collect()
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()


def reset_peak(device) -> None:
    """Start the memory peak here: what the benchmark made before (its
    inputs) is not the program's."""
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device) -> int:
    import torch

    return torch.cuda.max_memory_allocated() if str(device).startswith("cuda") else 0


class Outcome(NamedTuple):
    """What a driver hands back: the counts, the end-to-end values (trace 0
    runs), the records the per-layer readers read (trace 1 runs), the
    checks, the memory peak read before the reference ran."""

    attempted: int
    failed: int
    e2e: dict
    records: dict
    checks: list
    peak_bytes: int
