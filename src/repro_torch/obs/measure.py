"""Measured-vs-modeled cost accounting: the measurement plane.

The counterpart of `repro.obs.measure`. Everything `obs.costmodel` reports
is napkin math — a consistent ruler, not evidence. This module is the
other half: measured numbers from the same phases the model prices, and
the machinery to set the two against each other.

* **Per-phase measured timing** rides the training engine's phased
  dispatch (`repro_torch.train.solver_state`, tracing on): each of the
  four phases (precond_build / cg_solve / slq_logdet / eq2_backward) is
  fenced with `torch.cuda.synchronize()` on the card, and its span carries
  `measured_ms`, the phase's modeled bytes and launches
  (`costmodel.mll_phase_costs`) and the backend. `phase_model_comparison`
  aggregates those spans per (backend, phase) into a measured-vs-modeled
  table — `launch/obs_report --compare-model`.
* **Modeled-ms conversion**: modeled bytes become modeled milliseconds at
  a reference memory bandwidth (`--hbm-gbps`; default DEFAULT_HBM_GBPS, the
  H100 SXM 80GB's 3350 GB/s from NVIDIA's data sheet). The
  measured/modeled RATIO is the honest quantity: ~1 means the byte model
  explains the time; >> 1 means compute, launch overhead or host syncs
  dominate; << 1 means the model overcharges.
* **Timed-collective micro-harness**: `collective_microbench` times the
  mesh's two primitives — one ring hop and the closing reduce-scatter —
  against `costmodel.dist_collective_cost`'s byte volumes, yielding the
  achieved GB/s per collective: CUDA events on the card, host clocks after
  a barrier on gloo. A one-rank group has nothing to transfer: [].
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from . import costmodel
from . import metrics as _metrics

# reference bandwidth for modeled-bytes -> modeled-ms conversion: the H100
# SXM 80GB's HBM3, 3.35 TB/s (NVIDIA's data sheet); override per part
DEFAULT_HBM_GBPS = 3350.0

# the four phase-span names the training engine emits (and the order the
# comparison table lists them in)
PHASE_SPANS = ("precond_build", "cg_solve", "slq_logdet", "eq2_backward")


def phase_model_comparison(spans: list[dict], *,
                           hbm_gbps: float = DEFAULT_HBM_GBPS) -> list[dict]:
    """Aggregate phase spans into measured-vs-modeled rows.

    spans: trace events (`obs.report.load_trace`). Only spans carrying BOTH
    `measured_ms` and `modeled_hbm_bytes` in args participate (i.e. the
    engine's phased dispatch); everything else is ignored, so the function
    is safe on any trace. Returns one row per (backend, phase), ordered by
    backend then PHASE_SPANS order.
    """
    groups: dict[tuple, dict] = {}
    for ev in spans:
        args = ev.get("args") or {}
        if "measured_ms" not in args or "modeled_hbm_bytes" not in args:
            continue
        key = (str(args.get("backend", "?")), ev.get("name", "?"))
        g = groups.setdefault(key, {"steps": 0, "measured_ms": 0.0,
                                    "modeled_hbm_bytes": 0.0,
                                    "modeled_launches": 0})
        g["steps"] += 1
        g["measured_ms"] += float(args["measured_ms"])
        g["modeled_hbm_bytes"] += float(args["modeled_hbm_bytes"])
        g["modeled_launches"] += int(args.get("modeled_launches", 0))

    def order(key):
        backend, phase = key
        try:
            pi = PHASE_SPANS.index(phase)
        except ValueError:
            pi = len(PHASE_SPANS)
        return (backend, pi, phase)

    rows = []
    for key in sorted(groups, key=order):
        backend, phase = key
        g = groups[key]
        modeled_ms = g["modeled_hbm_bytes"] / (hbm_gbps * 1e9) * 1e3
        rows.append({
            "backend": backend,
            "phase": phase,
            "steps": g["steps"],
            "measured_ms": g["measured_ms"],
            "modeled_gb": g["modeled_hbm_bytes"] / 1e9,
            "modeled_ms": modeled_ms,
            "modeled_launches": g["modeled_launches"],
            "ratio": (g["measured_ms"] / modeled_ms) if modeled_ms > 0
                     else float("nan"),
        })
    return rows


def format_model_comparison(rows: list[dict], *,
                            hbm_gbps: float = DEFAULT_HBM_GBPS) -> str:
    """Render the measured-vs-modeled table (obs_report --compare-model)."""
    lines = [f"measured vs modeled (reference HBM bandwidth "
             f"{hbm_gbps:g} GB/s)",
             f"{'backend':<12} {'phase':<14} {'steps':>5} "
             f"{'measured_ms':>12} {'modeled_ms':>11} {'modeled_GB':>11} "
             f"{'ratio':>8}"]
    if not rows:
        lines.append("  (no phase spans with modeled costs in this trace — "
                     "run a traced fit)")
        return "\n".join(lines)
    for r in rows:
        ratio = f"{r['ratio']:8.2f}" if np.isfinite(r["ratio"]) else \
            f"{'-':>8}"
        lines.append(
            f"{r['backend']:<12} {r['phase']:<14} {r['steps']:>5} "
            f"{r['measured_ms']:>12.2f} {r['modeled_ms']:>11.3f} "
            f"{r['modeled_gb']:>11.4f} {ratio}")
    lines.append(
        "ratio = measured / modeled: ~1 bandwidth-bound as modeled; "
        ">>1 launch/sync overhead dominates (expected on CPU emulation); "
        "<<1 the model overcharges.")
    return "\n".join(lines)


def collective_microbench(mesh=None, geom=None, *, num_rhs: int = 8,
                          reps: int = 10, dtype=None) -> list[dict]:
    """Time the distributed engine's collectives against the byte model.

    mesh/geom: a `repro_torch.launch.mesh.Mesh` and its
    `core.distributed.DistGeometry`; None builds a mesh over the joined
    process group (2-D when the world factors, 1-D otherwise) at a small
    default n, and returns [] when no group is joined. Every rank must call
    it (the primitives are collectives). Each primitive runs once to warm
    up, then `reps` repetitions timed with CUDA events on the card or with
    the host clock after a barrier on the CPU; achieved GB/s uses the SAME
    per-rank byte volume `dist_collective_cost` charges. Returns [] when no
    collective exists (one rank).
    """
    import torch.distributed as dist

    from repro_torch.core.distributed import collective_bench_fns, make_geometry

    if mesh is None:
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return []
        from repro_torch.launch.mesh import make_mesh

        world = dist.get_world_size()
        device = "cpu" if dist.get_backend() == "gloo" else None
        # favor a 2-D (rows x cols) split so BOTH collectives get measured
        d_col = 1
        for c in (2, 4, 8):
            if world % c == 0 and world // c >= 2:
                d_col = c
        if d_col > 1:
            mesh = make_mesh((world // d_col, d_col), ("data", "model"),
                             device=device)
        else:
            mesh = make_mesh((world,), ("data",), device=device)
    if geom is None:
        n = 4096 * int(np.prod(mesh.devices.shape))
        geom = make_geometry(
            mesh, n, 8,
            mode="2d" if "model" in mesh.axis_names else "1d")

    fns = collective_bench_fns(mesh, geom)
    if not fns:
        return []
    if dtype is None:
        dtype = torch.float32
    v = torch.ones((geom.n_local, num_rhs), dtype=dtype, device=mesh.device)
    itemsize = v.element_size()
    cost = costmodel.dist_collective_cost(
        geom.n, num_rhs, d_row=int(np.prod(geom.row_sizes)),
        d_col=geom.d_col, dtype_bytes=itemsize)
    # per-rank bytes moved by ONE invocation of each primitive
    chunk = geom.n_local * num_rhs * itemsize
    bytes_per = {"ppermute_ring": float(chunk),
                 "psum_scatter": float(cost.scatter_bytes)}
    on_card = v.device.type == "cuda"

    rows = []
    for name, fn in fns.items():
        fn(v)  # warm up (communicator set-up)
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(v.device)
            start.record()
            for _ in range(reps):
                fn(v)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / reps
        else:
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(v)
            ms = (time.perf_counter() - t0) * 1e3 / reps
        nbytes = bytes_per.get(name, float(chunk))
        gbps = nbytes / 1e9 / (ms / 1e3) if ms > 0 else float("nan")
        _metrics.gauge(f"collective.{name}.ms").set(ms)
        _metrics.gauge(f"collective.{name}.gbps").set(gbps)
        rows.append({"collective": name, "reps": reps, "ms_per_op": ms,
                     "bytes_per_device": nbytes, "achieved_gbps": gbps,
                     "devices": int(np.prod(mesh.devices.shape))})
    return rows


def format_collective_bench(rows: list[dict]) -> str:
    if not rows:
        return ("collectives: one rank — nothing to measure "
                "(run in a process group of several ranks)")
    lines = [f"{'collective':<16} {'devices':>7} {'ms/op':>9} "
             f"{'KB/device':>10} {'achieved_GB/s':>13}"]
    for r in rows:
        lines.append(
            f"{r['collective']:<16} {r['devices']:>7} "
            f"{r['ms_per_op']:>9.3f} {r['bytes_per_device'] / 1e3:>10.1f} "
            f"{r['achieved_gbps']:>13.3f}")
    return "\n".join(lines)


def phase_histogram_summary(reg: Any | None = None) -> dict:
    """The registry's measured per-phase ms histograms (`phase.<name>_ms`),
    keyed by phase — the no-trace-file view of the same measurements."""
    r = reg if reg is not None else _metrics.registry()
    out = {}
    for phase in PHASE_SPANS:
        h = r.histogram(f"phase.{phase}_ms")
        if h.count:
            out[phase] = h.summary()
    return out
