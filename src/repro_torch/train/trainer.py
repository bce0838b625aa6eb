"""Generic fault-tolerant training loop.

The counterpart of `repro.train.trainer`. Model-agnostic: it drives any
`step_fn(state, batch) -> (new_state, metrics)` that returns a new state
and leaves the one it was given untouched (`launch.steps.make_train_step`
is one). Responsibilities that belong to the harness, not the model:

  * checkpoint / restart: `CheckpointManager`, atomic, auto-resume; a
    final checkpoint when the loop ends (skipped where the last step's
    periodic one is already on disk: the same arrays)
  * preemption: SIGTERM / SIGINT request one final checkpoint, then the
    loop exits (the handler is installed only on the main thread)
  * straggler / fault containment: a step whose metrics come back
    non-finite, or that took longer than `step_timeout_s`, is skipped (its
    new state is dropped) and counted; more than `max_consecutive_skips`
    skips in a row raise
  * throughput accounting (steps/s, tokens/s)

Reading the metrics to check them is the loop's one host sync per step.

Over a world of several ranks (the default process group) every rank runs
the loop, and every rank must take the same decision at every step, or the
next collective deadlocks. Once a step the ranks combine their stop
request, timeout and non-finite flags (a MAX all-reduce of three numbers;
none on a world of one), so a signal or a slow step on one rank stops or
skips every rank at the same step. A checkpoint gathers a sharded state
on every rank and rank 0 writes it (`train.checkpoint`); a resume hands
the restored host-canonical state to `place` (the same placement as the
run's first). Log lines come from rank 0.
"""

from __future__ import annotations

import math
import signal
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .checkpoint import CheckpointManager, flatten_with_keys, tree_from_numpy


class TrainLoopConfig(NamedTuple):
    total_steps: int
    ckpt_dir: str | None = None
    ckpt_every: int = 200
    ckpt_keep: int = 3
    log_every: int = 10
    max_consecutive_skips: int = 10
    step_timeout_s: float | None = None   # watchdog (None = off)
    tokens_per_step: int | None = None


class TrainLoopResult(NamedTuple):
    state: Any
    steps_run: int
    skipped: int
    metrics_history: list
    step_seconds: list = ()   # each accepted step's step_fn + metrics read


def _to_host(metrics):
    """Metrics as numpy values (tensors read once, in one sync; a DTensor
    metric's full value)."""
    if isinstance(metrics, dict):
        return {k: _to_host(v) for k, v in metrics.items()}
    if isinstance(metrics, torch.Tensor):
        from torch.distributed.tensor import DTensor

        if isinstance(metrics, DTensor):
            metrics = metrics.full_tensor()
        return metrics.detach().to("cpu", torch.float64).numpy()
    return np.asarray(metrics)


def _world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _agree(flags: list) -> list:
    """Each flag true if it is true on any rank: one MAX all-reduce over the
    world (on the card for NCCL), nothing on a world of one."""
    if _world()[1] == 1:
        return [bool(f) for f in flags]
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([float(f) for f in flags], device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return [bool(v) for v in t.tolist()]


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def run_train_loop(step_fn: Callable, state, batches, cfg: TrainLoopConfig,
                   *, log_fn=print, place: Callable | None = None) -> TrainLoopResult:
    """Run `step_fn` over `batches` (an iterator) with fault tolerance. A
    resumed state takes each checkpointed array as a tensor of the given
    state's leaf's dtype and device (`checkpoint.tree_from_numpy`), then
    goes through `place` where one is given (a sharded run's placement of
    a host-canonical state onto its mesh)."""
    if _world()[0] != 0:
        log_fn = _silent
    manager = None
    start_step = 0
    if cfg.ckpt_dir:
        manager = CheckpointManager(cfg.ckpt_dir, save_every=cfg.ckpt_every,
                                    keep=cfg.ckpt_keep)
        arrays, start_step, _ = manager.restore_or_init(state)
        if start_step:
            state = tree_from_numpy(state, arrays)
            if place is not None:
                state = place(state)
            log_fn(f"[trainer] resumed from step {start_step}")

    stop_requested = {"flag": False}   # this rank's; the loop reads `stop`

    def _handler(signum, frame):
        stop_requested["flag"] = True
        log_fn(f"[trainer] signal {signum}: checkpoint-and-exit requested")

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, _handler)
        except ValueError:  # not on the main thread (tests)
            pass

    history: list = []
    seconds: list = []
    skipped = 0
    consecutive_skips = 0
    step = start_step
    saved = start_step
    t_last = time.time()
    stop = False
    try:
        while step < cfg.total_steps and not stop:
            batch = next(batches)
            t0 = time.time()
            new_state, metrics = step_fn(state, batch)
            metrics = _to_host(metrics)
            dt = time.time() - t0

            bad = any(not np.all(np.isfinite(v)) for v in _leaves(metrics))
            timed_out = (cfg.step_timeout_s is not None and dt > cfg.step_timeout_s)
            stop, bad, timed_out = _agree([stop_requested["flag"], bad, timed_out])
            if bad or timed_out:
                skipped += 1
                consecutive_skips += 1
                reason = "non-finite metrics" if bad else f"timeout {dt:.1f}s"
                log_fn(f"[trainer] step {step}: SKIPPED ({reason}); state rolled back")
                if consecutive_skips > cfg.max_consecutive_skips:
                    raise RuntimeError(
                        f"{consecutive_skips} consecutive skipped steps — aborting")
                continue  # state NOT advanced: gradient-skip fault containment
            consecutive_skips = 0
            state = new_state
            step += 1
            history.append(metrics)
            seconds.append(dt)

            if step % cfg.log_every == 0:
                rate = cfg.log_every / max(time.time() - t_last, 1e-9)
                t_last = time.time()
                extra = ""
                if cfg.tokens_per_step:
                    extra = f" tok/s={cfg.tokens_per_step * rate:,.0f}"
                log_fn(f"[trainer] step {step}: {_fmt(metrics)} "
                       f"steps/s={rate:.3f}{extra}")
            if manager and manager.maybe_save(step, state, {"wall": time.time()}):
                saved = step
    finally:
        # the final checkpoint (not written again if this step's is on disk)
        if manager and step > start_step and saved != step:
            manager.maybe_save(step, state, {"wall": time.time(),
                                             "final": True}, force=True)
        for sig, h in old_handlers.items():
            signal.signal(sig, h)

    return TrainLoopResult(state=state, steps_run=step - start_step,
                           skipped=skipped, metrics_history=history,
                           step_seconds=seconds)


def _silent(*_):
    pass


def _fmt(metrics) -> str:
    parts = []
    for path, v in flatten_with_keys(metrics):
        name = path.strip("[]'\"")
        v = np.asarray(v, dtype=np.float64)
        parts.append(f"{name}={float(v.mean()) if v.size else math.nan:.4f}")
    return " ".join(parts)
