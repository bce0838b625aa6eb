"""Check and time the port's distributed engine across the cards of one host.

    torchrun --nproc_per_node=4 scripts/torch_dist_check.py [--n 524288]

Every rank takes card LOCAL_RANK and joins the NCCL group (torchrun's
rendezvous on this host). On the houseelectric-shaped data (d = 9, seeded
numpy draws, matern32 pre-scaled by sqrt(d)), for each layout of the world
— 2-D on a world x 1 mesh (a ring over every rank), 2-D on a 2 x 2 mesh
(ring over data, reduce-scatter over model) and 1-D (rows over every rank,
one all-gather) — and t = 1 and t = 9:

  * one K_hat MVM on the fused backend (`ShardedOperator`, the
    chunk-accumulate kernel per ring step) with the ring overlap off and
    on: the two must agree bit for bit, and with rank 0's single-card
    result (one fused-kernel launch over all n) within 2e-4 of max|out|;
  * the time of that MVM (CUDA events, the median of 5 after a warm-up,
    ranks aligned by a barrier before each), beside the single card's.

Then the mean-cache solve (`make_mean_cache_solve`, tol 1e-3) on the 2 x 2
mesh at n / 8 with noise 0.1 must reach its tolerance. Rank 0 prints one
JSON line per case, the card's name and power limit, and a last line
{"ok": true, ...}; any mismatch exits 1. It builds the kernels on rank 0
first (the others wait at a barrier) and needs no network beyond the
host's loopback.

    torchrun --nproc_per_node=2|4 scripts/torch_dist_check.py --lm

checks LM training over the cards instead: one smollm-360m train step
(`launch.steps.make_train_step`, fp32 weights and moments, lr 1e-6, the
synthetic stream's first global batch of 8 x 1024) on every (data, model)
mesh of the world — (2, 1) on two cards, (2, 2) and (4, 1) on four — the
state placed by `place_train_state` and the batch by `TokenPipeline`,
against rank 0's plain one-card step on the same state and batch: loss,
grad_norm and ce within 3e-5 relative, the gathered parameters and both
moments within 2e-4 of their largest entry (tests/test_torch_lm_dist.py's
gates). Each mesh's step is timed (the median of 3 after a warm-up, ranks
aligned by a barrier, host clock to a synchronize) beside the one card's.
With `--device cpu` it rehearses on gloo at the reduced config and a
global batch of 4 x 64.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core import distributed as D  # noqa: E402
from repro_torch.core.kernels_math import init_params  # noqa: E402
from repro_torch.kernels import build, kmvm  # noqa: E402
from repro_torch.kernels.ops import kmvm_block  # noqa: E402
from repro_torch.launch.mesh import init_distributed, make_mesh  # noqa: E402


def _median_ms(fn, reps: int = 5) -> float | None:
    """Median CUDA-event time of fn; None on the CPU (a rehearsal with
    `--device cpu` times nothing)."""
    cuda = torch.cuda.is_available() and dist.get_backend() == "nccl"
    fn()
    times = []
    for _ in range(reps):
        dist.barrier()
        if not cuda:
            fn()
            continue
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times)) if times else None


def _step_ms(fn, reps: int = 3) -> float:
    """Median wall ms of fn() after a warm-up, ranks aligned by a barrier
    before each, to a synchronize on the card."""
    cuda = dist.get_backend() == "nccl"
    fn()
    times = []
    for _ in range(reps):
        dist.barrier()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def lm_check(dev, say) -> bool:
    """The `--lm` check (see the module docstring); True if every mesh
    agrees with the one card."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (
        init_train_state, make_train_step, place_train_state)
    from repro_torch.models import get_arch
    from repro_torch.train.checkpoint import to_numpy

    rank, world = dist.get_rank(), dist.get_world_size()
    cfg = get_arch("smollm-360m")
    b, s = 8, 1024
    if dev.type == "cpu":
        cfg, b, s = cfg.reduced(), 4, 64
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             dtype=torch.float32, device=dev)

    def first(mesh):
        pipe = TokenPipeline(mesh, cfg.vocab, b, s, seed=0, device=dev)
        try:
            x = next(pipe)
        finally:
            pipe.close()
        return {"tokens": x.tokens, "targets": x.targets}

    ok = True
    plain = single_ms = None
    if rank == 0:
        step = make_train_step(cfg, None, lr=1e-6)
        batch = first(None)
        plain = step(state, batch)
        single_ms = _step_ms(lambda: step(state, batch))
    else:
        _step_ms(lambda: None)   # the same barriers as rank 0
    shapes = [(world, 1)] + ([(2, 2)] if world == 4 else [])
    for shape in shapes:
        mesh = make_host_mesh(*shape, device=dev)
        step = make_train_step(cfg, mesh, lr=1e-6)
        placed = place_train_state(mesh, state)
        batch = first(mesh)
        new, met = step(placed, batch)
        full = {part: {k: to_numpy(v) for k, v in getattr(new, part).items()}
                for part in ("params", "mu", "nu")}
        met = {k: float(to_numpy(v)) for k, v in met.items()}
        ms = _step_ms(lambda: step(placed, batch))
        row = {"case": "lm_step", "arch": cfg.name, "mesh": list(shape),
               "batch": [b, s], "ms": ms, "single_card_ms": single_ms,
               "fallbacks": dict(step.fallbacks)}
        if rank == 0:
            pnew, pmet = plain
            rel = {k: abs(met[k] - float(pmet[k])) / abs(float(pmet[k]))
                   for k in ("loss", "grad_norm", "ce")}
            state_err = max(
                float(np.max(np.abs(full[part][k] - to_numpy(v)))
                      / max(float(np.max(np.abs(to_numpy(v)))), 1e-30))
                for part in ("params", "mu", "nu")
                for k, v in getattr(pnew, part).items())
            row.update(rel_err=rel, state_err=state_err)
            ok &= max(rel.values()) <= 3e-5 and state_err <= 2e-4
        say(row)
        del placed, new
    return ok


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 19)
    ap.add_argument("--device", default="cuda",
                    help="'cpu' rehearses the same program on gloo")
    ap.add_argument("--lm", action="store_true",
                    help="check LM training over the world instead")
    args = ap.parse_args(argv)
    dev = init_distributed(args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    if args.lm:
        def say_lm(obj):
            if rank == 0:
                print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)

        if rank == 0 and dev.type == "cuda":
            say_lm(_card())
        ok = lm_check(dev, say_lm)
        return _finish(ok, dev, world, say_lm)
    if dev.type == "cuda":
        if rank == 0:
            build.build()
        dist.barrier()
        build.library()
    lead = rank == 0

    def say(obj):
        if lead:
            print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)

    if lead and dev.type == "cuda":
        say(_card())
    n, d = args.n, 9
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.normal(size=(n, d)), dtype=torch.float32, device=dev)
    params = init_params(lengthscale=math.sqrt(d), outputscale=1.0, noise=0.01,
                         device=dev)
    ok = True
    layouts = [("2d", (world, 1))]
    if world == 4:
        layouts.append(("2d", (2, 2)))
    layouts.append(("1d", (world, 1)))
    meshes = {}
    for t in (1, 9):
        V = torch.as_tensor(rng.normal(size=(n, t)), dtype=torch.float32,
                            device=dev)
        single = single_ms = None
        if lead:
            single = kmvm_block("matern32", X, X, V, params)
            single_ms = _median_ms(lambda: kmvm_block("matern32", X, X, V, params))
        else:
            _median_ms(lambda: None)  # the same barriers as rank 0
        for mode, shape in layouts:
            mesh = meshes.get(shape) or meshes.setdefault(
                shape, make_mesh(shape, ("data", "model"), device=dev))
            geom = D.make_geometry(mesh, n, d, mode=mode)
            cfg = D.DistMLLConfig(kernel="matern32", backend="pallas")
            v_loc = D.shard_vector(mesh, geom, V)
            ops = {ov: D.ShardedOperator(
                cfg.operator_config(geom._replace(overlap=ov)), X, params)
                for ov in (False, True)}
            kmvm.reset_launch_counts()
            outs = {ov: op.matvec(v_loc) for ov, op in ops.items()}
            launches = dict(kmvm.launch_counts)
            same = torch.equal(outs[False], outs[True])
            full = D._all_gather(mesh, geom.all_axes, outs[True])
            times = {ov: _median_ms(lambda op=op: op.matvec(v_loc))
                     for ov, op in ops.items()}
            row = {"case": "mvm", "mode": mode, "mesh": list(shape), "n": n,
                   "t": t, "overlap_bitwise": bool(same),
                   "ms_serial": times[False], "ms_overlap": times[True],
                   "launches_per_mvm": launches}
            if lead:
                want = single + 0.01 * V  # + sigma^2 V (noise 0.01)
                err = float(torch.max(torch.abs(full - want))
                            / torch.max(torch.abs(want)))
                row.update(rel_err_vs_single=err, single_card_ms=single_ms)
                # 1-D serial is the gathered slab path and 1-D overlap the
                # ring: only the 2-D arms walk the same chunk steps
                ok &= (same or mode == "1d") and err <= 2e-4
            say(row)
    mesh = meshes.get((2, 2)) or meshes[(world, 1)]
    m = n // 8
    p2 = init_params(lengthscale=math.sqrt(d), outputscale=1.0, noise=0.1,
                     device=dev)
    y = torch.sin(X[:m].sum(1)) + 0.1 * torch.as_tensor(
        rng.normal(size=m), dtype=torch.float32, device=dev)
    geom = D.make_geometry(mesh, m, d, mode="2d")
    cfg = D.DistMLLConfig(kernel="matern32", backend="pallas", precond_rank=100)
    kmvm.reset_launch_counts()
    a, rel = D.make_mean_cache_solve(mesh, geom, cfg, tol=1e-3, max_iters=400)(
        D.pad_to_geometry(geom, X[:m]), D.shard_vector(mesh, geom, y), p2)
    rel = float(rel.max())
    say({"case": "mean_cache_solve", "mesh": list(mesh.shape), "n": m,
         "rel_residual": rel, "iterations": kmvm.launch_counts["kmvm_chunk"]
         // max(geom.d_row, 1), "finite": bool(torch.isfinite(a).all())})
    ok &= rel <= 1e-3 and bool(torch.isfinite(a).all())
    _finish(ok, dev, world, say)


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


def _finish(ok, dev, world, say) -> None:
    """Agree on `ok` over the world, print the last line, exit 0 / 1."""
    flags = torch.tensor([float(ok)], device=dev)
    dist.all_reduce(flags, op=dist.ReduceOp.MIN)
    ok = bool(flags.item())
    say({"ok": ok, "device": {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
        "count": world}})
    dist.destroy_process_group()
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
