"""Column-split autotuner for the fused kernels B1/B2 (`kmvm_fused`,
`kmvm_fused_dots`).

The counterpart of `repro.kernels.autotune`, which sweeps the Pallas tile
sizes (bm, bn). On this card the tiles are the kernels' own (64 x 64); the
knob is `tiles_per_split`, the column tiles each block of a launch walks
(`kmvm._column_split`). More splits fill the 132 SMs when the row tiles
alone are too few, at the price of a partial buffer (nsplit, m, t) and
the split-sum pass; fewer splits cost a wave tail when they are not. The
right choice depends on the card, the compute dtype, the spec's fused pass
and the shape, none of which the static default (`kmvm._SPLIT_TILES`) can
see. This module sweeps a small candidate set once per (card, dtype,
kernel structure, shape bucket) and caches the winner on disk, so the cost
is paid once per machine, not once per process.

Cache design, as the reference's:

* The key is a plain dict of everything the measurement depends on: the
  CUDA device name, the compute dtype, the STATIC component structure of
  the fused pass, and n, d and t bucketed to the next power of two. The
  entry points take the launch's row count `m` where the reference's do
  (`cache_key(components, m, n, d, t)`, `tiles_for_spec(kernel, params,
  m, n, d, t)`), but `m` never enters the key: a row's result must not
  depend on how many rows a launch has (`kmvm._column_split`), so the
  split depends on n only, and a split keyed on rows would break that
  pin. The sweep times (n, n) launches whatever `m` is.
* The on-disk filename is the sha1 of the canonical-JSON key; writes go
  through an atomic rename, so concurrent processes race benignly. The
  default directory is the port's own (`~/.cache/repro-gp/autotune-torch`,
  or `REPRO_TORCH_AUTOTUNE_CACHE`): the reference's entries hold (bm, bn)
  and are never read as the port's (an entry without `tiles_per_split` is
  a miss).
* Entries store the full timing table; lookups read `tiles_per_split`.
* A process-level memo avoids re-reading the file. A sweep launches and
  times kernels, which it must not do while a CUDA graph is being captured
  or under `torch.compile`, so a miss there returns the static default
  without sweeping or memoizing (`autotune.trace_fallbacks`); `prewarm`
  fills the cache eagerly before such a region.

Determinism: candidates are swept in a fixed order and ties break toward
the FIRST candidate at the minimal time, so a fixed `measure` function
always yields the same choice (tests/test_torch_autotune.py).

On a CPU tensor the kernels' plain versions have no column split, so
`tiles_for_spec` returns the static default there without sweeping. On the
card nothing falls back: a launch that fails during a sweep raises.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Callable

import torch

from repro_torch import obs
from repro_torch.device import resolve_device

from . import kmvm

# Sweep order is part of the determinism contract (ties break earliest).
# 0 = the whole column range in one split (one block per row tile).
DEFAULT_CANDIDATES: tuple[int, ...] = (16, 32, 64, 128, 256, 0)
DEFAULT_TILES = kmvm._SPLIT_TILES

_MEMO: dict[str, int] = {}
_LOCK = threading.Lock()


def default_cache_dir() -> str:
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "repro-gp", "autotune-torch")


def shape_bucket(x: int) -> int:
    """Next power of two (>= 1): the cache's shape granularity."""
    b = 1
    while b < x:
        b *= 2
    return b


def cache_key(components, m: int, n: int, d: int, t: int, *,
              compute_dtype: str, device_name: str | None = None) -> dict:
    """Everything the winning split depends on, as a canonical plain dict.
    `m`, the launch's row count, is not in it (see the module docstring)."""
    return {
        "device": device_name if device_name is not None
        else torch.cuda.get_device_name(),
        "compute_dtype": str(compute_dtype),
        "components": [list(kinds) for kinds in components],
        "n": shape_bucket(n),
        "d": shape_bucket(d),
        "t": shape_bucket(t),
    }


def key_hash(key: dict) -> str:
    return hashlib.sha1(
        json.dumps(key, sort_keys=True).encode()).hexdigest()


def _capturing() -> bool:
    """True while launching and timing kernels is not allowed: a CUDA graph
    is being captured on the current stream, or torch.compile is tracing."""
    if torch.compiler.is_compiling():
        return True
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _default_measure(key: dict) -> Callable[[int], float]:
    """Seconds of one B1 plus one B2 launch at the key's bucketed (n, n, d,
    t), at a given split.

    Operands are zeros (the kernels have no data-dependent control flow, so
    their time is data-independent), the launches are the real
    `kmvm_fused` / `kmvm_fused_dots`, timed with CUDA events on the current
    stream: one warm-up launch each, then the minimum of 3.
    """
    components = tuple(tuple(kinds) for kinds in key["components"])
    cdt = getattr(torch, key["compute_dtype"])
    n, d, t = key["n"], key["d"], key["t"]
    dev = torch.device("cuda")
    X = torch.zeros((n, d), dtype=cdt, device=dev)
    V = torch.zeros((n, t), dtype=cdt, device=dev)
    rows = torch.zeros((n, t), dtype=torch.float32, device=dev)
    scalars = torch.ones((kmvm.scalar_layout(components),),
                         dtype=torch.float32, device=dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)

    def best_ms(run) -> float:
        run()  # warm-up
        best = float("inf")
        for _ in range(3):
            start.record()
            run()
            stop.record()
            stop.synchronize()
            best = min(best, start.elapsed_time(stop))
        return best

    def measure(split: int) -> float:
        b1 = best_ms(lambda: kmvm.kmvm_fused(components, X, X, V, scalars,
                                             split))
        b2 = best_ms(lambda: kmvm.kmvm_fused_dots(
            components, X, X, V, rows, rows, scalars, split))
        return (b1 + b2) * 1e-3

    return measure


def autotune_tiles(
    components,
    m: int,
    n: int,
    d: int,
    t: int,
    *,
    compute_dtype: str = "float32",
    device_name: str | None = None,
    candidates: tuple[int, ...] | None = None,
    measure: Callable[[int], float] | None = None,
    cache_dir: str | None = None,
) -> int:
    """The cached `tiles_per_split` for this (card, dtype, structure, shape
    bucket) of an (m, n) x (n, t) launch, swept and persisted on first
    sight. The split depends on n only, so every m shares one entry.

    measure: split -> seconds; injectable for tests. The default times real
    B1 and B2 launches at the bucketed shapes. device_name: the key's card
    (None = `torch.cuda.get_device_name()`).
    """
    key = cache_key(components, m, n, d, t, compute_dtype=compute_dtype,
                    device_name=device_name)
    h = key_hash(key)
    with _LOCK:
        if h in _MEMO:
            obs.counter("autotune.hits").inc()
            return _MEMO[h]

        cdir = cache_dir if cache_dir is not None else default_cache_dir()
        path = os.path.join(cdir, h + ".json")
        try:
            with open(path) as f:
                choice = int(json.load(f)["tiles_per_split"])
            _MEMO[h] = choice
            obs.counter("autotune.hits").inc()
            return choice
        except (OSError, ValueError, KeyError, TypeError):
            pass

        if _capturing():
            # a miss while capturing: a timed launch is not allowed here.
            # Fall back to the static default and do NOT memoize, so that a
            # later eager call (prewarm) still runs the sweep.
            obs.counter("autotune.trace_fallbacks").inc()
            return DEFAULT_TILES

        obs.counter("autotune.misses").inc()
        if measure is None:
            measure = _default_measure(key)
        cands = candidates if candidates is not None else DEFAULT_CANDIDATES
        timings = {}
        best = None
        sweep_t0 = time.perf_counter()
        with obs.span("autotune_sweep", candidates=len(cands), n=key["n"],
                      t=key["t"]) as sp:
            for split in cands:
                secs = float(measure(split))
                timings[str(split)] = secs
                # strict < : ties break toward the earliest candidate
                if best is None or secs < best[0]:
                    best = (secs, split)
            sp.set(tiles_per_split=best[1])
        choice = best[1]
        obs.counter("autotune.sweeps").inc()
        obs.histogram("autotune.sweep_ms").observe(
            (time.perf_counter() - sweep_t0) * 1e3)

        os.makedirs(cdir, exist_ok=True)
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"key": key, "tiles_per_split": choice,
                       "timings": timings}, f, indent=1, sort_keys=True)
        os.replace(tmp, path)  # atomic: concurrent processes race benignly
        _MEMO[h] = choice
        return choice


def clear_memo() -> None:
    """Drop the process-level memo (tests; disk entries are untouched)."""
    with _LOCK:
        _MEMO.clear()


def tiles_for_spec(kernel, params, m: int, n: int, d: int, t: int, *,
                   device=None, compute_dtype=None,
                   device_name: str | None = None,
                   cache_dir: str | None = None) -> int:
    """Operator-facing entry: the autotuned split of the spec's fused pass
    for an (m, n) x (n, t) launch on `device` (None = the card; raises when
    there is none); the static default on a CPU device (the plain versions
    have no split) or when the spec has no fused pass to tune."""
    from .ops import _compute_dtype, mvm_plan

    device = resolve_device(device)
    if device.type != "cuda":
        return DEFAULT_TILES
    plan = mvm_plan(kernel, params)
    if not plan.passes:
        return DEFAULT_TILES
    if device_name is None:
        device_name = torch.cuda.get_device_name(device)
    cdt = str(_compute_dtype(compute_dtype)).removeprefix("torch.")
    return autotune_tiles(plan.passes[0].components, m, n, d, t,
                          compute_dtype=cdt, device_name=device_name,
                          cache_dir=cache_dir)


def prewarm(kernel, params, n: int, d: int, *, device=None,
            num_probes: int = 8, compute_dtype=None,
            device_name: str | None = None,
            cache_dir: str | None = None) -> int:
    """Resolve (and persist) the training shape's split before the first
    training step, so that a sweep's time lands in set-up
    (`repro_torch.train.gp_trainer`). t is the mBCG RHS count: y + probes."""
    return tiles_for_spec(kernel, params, n, n, d, num_probes + 1,
                          device=device, compute_dtype=compute_dtype,
                          device_name=device_name, cache_dir=cache_dir)
