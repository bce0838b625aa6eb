"""Training launcher: the paper's exact GP through the distributed engine.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gp-exact-1m \
        [--gp-n 8192] [--steps 100] [--gp-mode 1d|2d] \
        [--gp-backend partitioned|pallas|blocksparse] [--gp-overlap] \
        [--data D] [--model M] [--save-artifact DIR] [--device cuda|cpu] \
        [--obs-trace trace.jsonl]

    torchrun --nproc_per_node=8 -m repro_torch.launch.train \
        --arch gp-exact-1m --gp-n 786432 --gp-mode 2d --model 2 ...

The counterpart of `repro.launch.train`'s `--arch gp-exact-1m` path, with the
reference's flags and defaults. One process per rank: under `torchrun` each
rank joins the NCCL group from RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR
and takes card LOCAL_RANK; a lone process forms a one-rank group through a
`file://` store. `--device cpu` runs the same program on gloo (default:
the card; without one it raises). The mesh is (data, model) over the
world (`--data` defaults to world / model).

The houseelectric analogue (`data/synthetic.py`, 4/9 of 3 x `--gp-n`
points train) is padded — never truncated — to the mesh's shard grid, the
hyperparameters train with Adam (lr 0.1) through `DistWarmStartEngine`
(precond rank 100, 8 probes, <= 20 CG steps at tol 1.0), and blocksparse
runs replan the sparsity whenever the hyperparameters drift past the plan's
margin. `--save-artifact` fits a servable posterior on rank 0 on the true
rows (single-device `fit_posterior` on the same backend) and saves it.
Rank 0 prints one line per step; `main` returns a report dict.
`--obs-trace PATH` traces the run (`repro_torch.obs`: an `mll_step` span
per step with the solver record's counters) and writes the JSONL when it
ends, rank 0 to PATH and rank r > 0 to PATH.rank<r>; render it with
`python -m repro_torch.launch.obs_report PATH`.

Any other `--arch` trains that LM (the reference's LM path):

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        [--full] [--steps 100] [--batch 8] [--seq 128] [--lr 1e-3] \
        [--ckpt checkpoints] [--ckpt-every 100] [--log-every 10] [--device cpu]

    torchrun --nproc_per_node=N -m repro_torch.launch.train \
        --arch smollm-360m --full [--data D] [--model M] ...

Without `--full` the config is `reduced(ce_chunk=seq, attn_chunk=seq)`.
The path is the host mesh over the world, `launch.steps.make_train_step`
on bf16 weights with fp32 AdamW moments, the synthetic `TokenPipeline`
(seed 0), and `train.trainer.run_train_loop` with checkpoints under
`<ckpt>/<arch name>`: it resumes from the latest one, skips a step whose
metrics are not finite, and on SIGTERM / SIGINT writes a final checkpoint
and stops. `--batch` is the global batch. On a world of one the state and
the batches are plain tensors. Over N ranks the mesh is (data, model) with
`--data` = N / `--model` by default, as the reference's host mesh: the
state is placed as DTensors (`launch.steps.place_train_state`: parameters
and both AdamW moments FSDP over the data axes and TP over model by
`models.sharding.param_pspec`, the step replicated), each rank feeds its
rows of the global batch (`TokenPipeline` with the mesh), and the loop
agrees across the ranks once a step; its checkpoints are gathered and
written by rank 0 in the one-rank layout, so a run resumes on another
world size. Rank 0 prints the reference's lines plus tokens/s over the
global batch (at the median accepted step: checkpoint writes and set-up
stay out), and `main` returns the same report on every rank (losses,
steps run and skipped, the final state, step seconds, tokens/s, the mesh
and the ops that ran on replicated operands). `main(argv, wrap_step=f)`
trains with `f(step_fn)` in place of the step function (a hook for tests
and the card's smoke run).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

GP_ARCH = "gp-exact-1m"


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--data", type=int, default=None, help="mesh data size")
    ap.add_argument("--model", type=int, default=1, help="mesh model size")
    ap.add_argument("--ckpt", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=100,
                    help="LM path: checkpoint every K steps")
    ap.add_argument("--log-every", type=int, default=10,
                    help="LM path: log every K steps")
    ap.add_argument("--gp-mode", default="2d", choices=("1d", "2d"))
    ap.add_argument("--gp-n", type=int, default=8192)
    ap.add_argument("--gp-kernel", default="matern32",
                    help="kernel: a stationary kind (matern32) or a spec "
                         "expression, e.g. '0.5*rbf + matern32'")
    ap.add_argument("--gp-backend", default="partitioned",
                    choices=("partitioned", "pallas", "blocksparse"),
                    help="inner backend per rank tile (pallas = the fused "
                         "CUDA kernels; blocksparse Morton-sorts the data)")
    ap.add_argument("--gp-overlap", action="store_true",
                    help="ring-pipeline the per-iteration gather against the "
                         "local tile compute")
    ap.add_argument("--gp-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="operator compute dtype")
    ap.add_argument("--gp-refresh-every", type=int, default=5,
                    help="rebuild the preconditioner + redraw the probes every "
                         "K steps (0 = every step cold)")
    ap.add_argument("--gp-drift-threshold", type=float, default=0.1,
                    help="relative hyperparameter drift that forces a refresh")
    ap.add_argument("--save-artifact", default="",
                    help="directory: persist a servable PosteriorArtifact")
    ap.add_argument("--obs-trace", default="",
                    help="path: write a repro_torch.obs span-trace JSONL for "
                         "this run (render with `python -m repro_torch.launch."
                         "obs_report <path>`); equivalent to setting "
                         "REPRO_TORCH_OBS_TRACE")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' on purpose)")
    return ap.parse_args(argv)


def main(argv=None, *, wrap_step=None) -> dict:
    """Run the launcher; returns the report of the GP or the LM path."""
    args = parse_args(argv)
    if args.arch != GP_ARCH:
        return _train_lm(args, wrap_step)
    return _train_gp(args)


def _train_lm(args, wrap_step=None) -> dict:
    import os
    import time

    import torch.distributed as dist

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.mesh import data_axes, make_host_mesh, mesh_axis_sizes
    from repro_torch.launch.steps import (
        init_train_state, make_train_step, place_train_state,
    )
    from repro_torch.models import count_params, get_arch
    from repro_torch.train.trainer import TrainLoopConfig, run_train_loop

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced(ce_chunk=args.seq, attn_chunk=args.seq)
    mesh = make_host_mesh(data=args.data, model=args.model, device=args.device)
    lead = mesh.rank == 0
    sharded = dist.get_world_size() > 1
    if lead:
        print(f"[train] arch={cfg.name} params={count_params(cfg):,} "
              f"mesh={dict(zip(mesh.axis_names, mesh.shape))}", flush=True)

    step = make_train_step(cfg, mesh, lr=args.lr)
    fallbacks = step.fallbacks
    if wrap_step is not None:
        step = wrap_step(step)
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    state = init_train_state(cfg, gen, device=mesh.device)
    place = (lambda st: place_train_state(mesh, st)) if sharded else None
    if sharded:
        state = place(state)
    pipe = TokenPipeline(mesh if sharded else None, cfg.vocab, args.batch,
                         args.seq, data_axes=data_axes(mesh), device=mesh.device)
    batches = ({"tokens": b.tokens, "targets": b.targets} for b in pipe)
    tokens_per_step = args.batch * args.seq
    loop = TrainLoopConfig(total_steps=args.steps,
                           ckpt_dir=os.path.join(args.ckpt, cfg.name),
                           ckpt_every=args.ckpt_every,
                           log_every=args.log_every,
                           tokens_per_step=tokens_per_step)
    t0 = time.time()
    try:
        res = run_train_loop(step, state, batches, loop,
                             log_fn=lambda m: print(m, flush=True), place=place)
    finally:
        pipe.close()
    seconds = time.time() - t0
    # the median accepted step (its step_fn and the metrics' read, which
    # waits for the card): checkpoint writes and set-up stay out
    step_s = float(np.median(res.step_seconds)) if res.step_seconds else float("nan")
    tok_s = tokens_per_step / step_s
    if lead:
        print(f"[train] done: {res.steps_run} steps, {res.skipped} skipped "
              f"tokens/s={tok_s:,.0f} (median step {step_s * 1e3:.1f} ms; "
              f"{seconds:.1f} s in the loop)", flush=True)
    return {"arch": cfg.name, "steps_run": res.steps_run,
            "skipped": res.skipped,
            "losses": [float(m["loss"]) for m in res.metrics_history],
            "state": res.state, "seconds": seconds, "tokens_per_s": tok_s,
            "step_seconds": res.step_seconds, "ckpt_dir": loop.ckpt_dir,
            "mesh": mesh_axis_sizes(mesh), "fallbacks": dict(fallbacks)}


def prepare_gp_data(mesh, X_host, y_host, *, backend, gp_mode, kernel,
                    params, margin=0.1, overlap=False, row_block=1024,
                    tile=256):
    """(geom, X, y, plan) for the distributed engine — NO point dropped.

    Every row of (X_host, y_host) trains: non-divisible n pads the layout
    with masked rows (see `DistGeometry`) instead of truncating. The
    blocksparse path Morton-sorts the data, pads, and builds the plan on
    the padded array so every per-rank chunk owns whole tiles; `tile`
    shrinks to 8 when the dataset is smaller than one tile per rank.
    Returned X/y are float32 CPU tensors with geom.n_padded rows; rows
    [geom.n:] are zero pad, excluded from every solve.
    """
    from repro_torch.core.distributed import make_geometry, pad_to_geometry

    X_host, y_host = np.asarray(X_host), np.asarray(y_host)
    n, d = X_host.shape
    if backend == "blocksparse":
        from repro_torch.sparse import build_plan, morton_order

        if n < mesh.devices.size * tile:
            tile = 8
        perm = morton_order(X_host)
        geom = make_geometry(mesh, n, d, mode=gp_mode, row_block=row_block,
                             overlap=overlap, tile_multiple=tile)
        X = pad_to_geometry(geom, torch.as_tensor(X_host[perm], dtype=torch.float32))
        y = pad_to_geometry(geom, torch.as_tensor(y_host[perm], dtype=torch.float32))
        plan = build_plan(kernel, X, params, tile=tile, margin=margin,
                          assume_sorted=True)
        return geom, X, y, plan
    geom = make_geometry(mesh, n, d, mode=gp_mode, row_block=row_block,
                         overlap=overlap)
    X = pad_to_geometry(geom, torch.as_tensor(X_host, dtype=torch.float32))
    y = pad_to_geometry(geom, torch.as_tensor(y_host, dtype=torch.float32))
    return geom, X, y, None


def _train_gp(args) -> dict:
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(data=args.data, model=args.model, device=args.device)
    lead = mesh.rank == 0
    if args.obs_trace:
        from repro_torch import obs

        obs.enable_tracing(args.obs_trace if lead
                           else f"{args.obs_trace}.rank{mesh.rank}")
        try:
            return _train_gp_run(args, mesh)
        finally:
            obs.disable_tracing()
    return _train_gp_run(args, mesh)


def _train_gp_run(args, mesh) -> dict:
    from repro_torch.core.distributed import DistMLLConfig, replicate, shard_vector
    from repro_torch.core.kernels_math import (
        KERNEL_KINDS, init_params_for, parse_kernel, spec_expr)
    from repro_torch.data.synthetic import make_regression_dataset
    from repro_torch.launch.mesh import mesh_axis_sizes
    from repro_torch.optim import adam_init, adam_update
    from repro_torch.train.solver_state import DistWarmStartEngine, WarmStartConfig

    lead = mesh.rank == 0

    def say(msg):
        if lead:
            print(msg, flush=True)

    s = make_regression_dataset("houseelectric", max_points=args.gp_n * 3)
    gp_dtype = None if args.gp_dtype == "float32" else args.gp_dtype
    kernel = args.gp_kernel if args.gp_kernel in KERNEL_KINDS \
        else parse_kernel(args.gp_kernel)
    params = init_params_for(kernel, noise=0.3, dtype=torch.float32,
                             device=mesh.device)
    kernel_desc = kernel if isinstance(kernel, str) else spec_expr(kernel)

    geom, X, y, plan = prepare_gp_data(
        mesh, s.X_train, s.y_train, backend=args.gp_backend,
        gp_mode=args.gp_mode, kernel=kernel, params=params,
        margin=args.gp_drift_threshold, overlap=args.gp_overlap)
    n = geom.n
    if n != s.X_train.shape[0]:
        raise AssertionError("no training point may be dropped")
    if plan is not None:
        say(f"[train-gp] sparsity plan: {plan}")
    if geom.has_pad:
        say(f"[train-gp] padded layout: {geom.pad_rows} masked rows "
            f"({n} -> {geom.n_padded})")
    cfg = DistMLLConfig(kernel=kernel, precond_rank=100, num_probes=8,
                        max_cg_iters=20, cg_tol=1.0, backend=args.gp_backend,
                        compute_dtype=gp_dtype, plan=plan)
    warm = WarmStartConfig(enabled=args.gp_refresh_every > 0,
                           refresh_every=max(args.gp_refresh_every, 1),
                           drift_threshold=args.gp_drift_threshold)
    engine = DistWarmStartEngine(mesh, geom, cfg, warm)
    state = adam_init(params)
    telemetry_done: list = []  # closed-out engines' telemetry (replans)
    Xr, ys = replicate(mesh, X), shard_vector(mesh, geom, y)
    say(f"[train-gp] n={n} kernel={kernel_desc} mode={args.gp_mode} "
        f"backend={args.gp_backend} dtype={args.gp_dtype} "
        f"refresh_every={args.gp_refresh_every} mesh={mesh_axis_sizes(mesh)} "
        f"device={mesh.device}")
    losses, replans = [], []
    for step_i in range(args.steps):
        if plan is not None:
            from repro_torch.sparse import build_plan, needs_replan

            replan, drift = needs_replan(plan, params, args.gp_drift_threshold,
                                         kernel=kernel)
            if replan:
                plan = build_plan(kernel, X, params, tile=plan.tile,
                                  margin=args.gp_drift_threshold,
                                  assume_sorted=True)
                cfg = cfg._replace(plan=plan)
                telemetry_done.extend(engine.telemetry)
                engine = DistWarmStartEngine(mesh, geom, cfg, warm)
                replans.append((step_i, drift))
                say(f"[train-gp] step {step_i}: replanned sparsity "
                    f"(drift={drift:.3f}, fill={plan.fill:.3f})")
        gen = torch.Generator(device=mesh.device).manual_seed(step_i)
        loss, aux, grads = engine.step(Xr, ys, params, gen)
        params, state = adam_update(params, grads, state, 0.1)
        t = engine.telemetry[-1]
        losses.append(float(loss))
        say(f"[train-gp] step {step_i}: nll/n={losses[-1]:.4f} "
            f"solve={t['mode']} cg_iters={t['cg_iters']} "
            f"drift={t['drift']:.3f} dt={t['seconds']:.2f}s")
    telemetry_done.extend(engine.telemetry)
    total = sum(t["cg_iters"] for t in telemetry_done)
    refreshes = sum(t["refreshed"] for t in telemetry_done)
    say(f"[train-gp] solver telemetry: total_cg_iters={total} "
        f"precond_refreshes={refreshes} steps={args.steps}")
    report = {"n": n, "d": int(X.shape[1]), "mesh": mesh, "geom": geom,
              "cfg": cfg, "kernel": kernel, "params": params, "X": Xr,
              "y": y, "y_local": ys, "losses": losses,
              "telemetry": telemetry_done, "replans": replans, "data": s,
              "artifact": None}

    if args.save_artifact and lead:
        # mesh-trained hyperparameters -> a servable single-device artifact,
        # fit on the TRUE rows only (pad rows are layout, not data)
        from repro_torch.core.operators import OperatorConfig, make_operator
        from repro_torch.serve.artifact import fit_posterior, save_artifact

        X_true, y_true = X[:n], y[:n]
        art_plan = None
        if plan is not None:
            from repro_torch.sparse import build_plan

            art_plan = build_plan(cfg.kernel, X_true, params, tile=plan.tile,
                                  margin=args.gp_drift_threshold,
                                  assume_sorted=True)
        op = make_operator(
            OperatorConfig(kernel=cfg.kernel, backend=args.gp_backend,
                           compute_dtype=gp_dtype, plan=art_plan),
            X_true, params, device=mesh.device)
        art = fit_posterior(
            op, y_true, precond_rank=cfg.precond_rank,
            generator=torch.Generator(device=mesh.device).manual_seed(args.steps))
        path = save_artifact(args.save_artifact, art)
        report.update(artifact=path,
                      artifact_rel_residual=art.meta["solve_rel_residual"])
        say(f"[train-gp] artifact: {path} "
            f"(rel_residual={art.meta['solve_rel_residual']:.2e})")
    return report


if __name__ == "__main__":
    main()
