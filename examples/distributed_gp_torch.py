"""End-to-end driver: distributed exact-GP training on a process-group
mesh, the port's counterpart of `examples/distributed_gp.py`.

The million-point recipe at demo scale: the `repro_torch.core.distributed`
engine on a (data, model) mesh — row-sharded kernel partitions, the
distributed pivoted-Cholesky preconditioner, fixed-trip PCG with
convergence masking, the Eq. 2 hyperparameter gradients — then the
tight-tolerance distributed mean-cache solve, single-device predictions
from the cache, and the mesh-solved posterior saved as a
`repro_torch.serve` artifact and served through the PredictionEngine.

    PYTHONPATH=src python examples/distributed_gp_torch.py --device cpu [--world 4] [--mode 2d]
    PYTHONPATH=src python examples/distributed_gp_torch.py            # one NCCL rank on the card
    torchrun --nproc_per_node=4 examples/distributed_gp_torch.py      # one rank per card

With `--device cpu` and no launcher the script starts a gloo world of
`--world` processes itself (a `file://` store in a temporary directory);
on the card a lone process is a one-rank NCCL group. The mesh is
(world / 2, 2) for `--mode 2d` on an even world, else (world, 1). Rank 0
prints; `main(argv)` returns rank 0's report in a lone process.
"""

import argparse
import os
import tempfile
import time

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="2d", choices=("1d", "2d"),
                    help="1d = paper-faithful row partitioning; "
                         "2d = row x column partitioning")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--points", type=int, default=18432,
                    help="protein-analogue points (4/9 of them train)")
    ap.add_argument("--world", type=int, default=4,
                    help="CPU ranks to start (with --device cpu, no launcher)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' on purpose)")
    ap.add_argument("--artifact", default="artifacts/distributed_gp_torch")
    return ap.parse_args(argv)


def run(args) -> dict:
    """The program of one rank, on the already-joined default group."""
    import torch.distributed as dist

    from repro_torch.core.distributed import (
        DistMLLConfig, make_geometry, make_mean_cache_solve,
        make_mll_value_and_grad, replicate, shard_vector,
    )
    from repro_torch.core.gp import rmse
    from repro_torch.core.kernels_math import init_params, kernel_matrix
    from repro_torch.data.synthetic import make_regression_dataset
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adam_init, adam_update

    world = dist.get_world_size() if dist.is_initialized() else 1
    model = 2 if args.mode == "2d" and world % 2 == 0 else 1
    mesh = make_host_mesh(model=model, device=args.device)
    dev = mesh.device
    rank0 = mesh.rank == 0

    def say(msg):
        if rank0:
            print(msg, flush=True)

    say(f"mesh: {dict(zip(mesh.axis_names, mesh.shape))} mode={args.mode} "
        f"on {mesh.backend}/{dev.type}")
    s = make_regression_dataset("protein", max_points=args.points)
    n = (s.X_train.shape[0] // 8) * 8
    X = torch.as_tensor(s.X_train[:n], dtype=torch.float32)
    y = torch.as_tensor(s.y_train[:n], dtype=torch.float32)
    Xt = torch.as_tensor(s.X_test[:1000], dtype=torch.float32, device=dev)
    yt = torch.as_tensor(s.y_test[:1000], dtype=torch.float32, device=dev)
    say(f"n={n} d={X.shape[1]}")

    geom = make_geometry(mesh, n, X.shape[1], mode=args.mode, row_block=512)
    cfg = DistMLLConfig(kernel="matern32", precond_rank=50, num_probes=8,
                        max_cg_iters=25, cg_tol=1.0)   # paper: eps = 1 training
    vg = make_mll_value_and_grad(mesh, geom, cfg)

    params = init_params(noise=0.3)
    Xr, ys = replicate(mesh, X), shard_vector(mesh, geom, y)
    state = adam_init(params)
    losses = []
    for step in range(args.steps):
        t0 = time.time()
        gen = torch.Generator(device=dev).manual_seed(step)   # alike on every rank
        loss, aux, grads = vg(Xr, ys, replicate(mesh, params), gen)
        params, state = adam_update(params, grads, state, 0.1)
        params = replicate(mesh, params)
        losses.append(float(loss))
        say(f"step {step}: nll/n={float(loss):.4f} "
            f"cg_iters={int(aux[2][0])} ({time.time() - t0:.1f}s)")

    # one-time tight-tolerance precomputation (distributed), then O(n)
    # single-device predictions from the cache
    solve = make_mean_cache_solve(mesh, geom, cfg, tol=0.01, max_iters=200)
    t0 = time.time()
    a_cache, rel = solve(Xr, ys, replicate(mesh, params))
    say(f"mean-cache solve: rel_residual={float(rel[0]):.2e} "
        f"({time.time() - t0:.1f}s)")
    report = {"losses": losses, "rel_residual": float(rel[0])}
    if not rank0:
        return report

    t0 = time.time()
    Kstar = kernel_matrix("matern32", Xt, Xr, params)
    mean = Kstar @ a_cache + params.raw_mean
    report["rmse"] = float(rmse(mean, yt))
    say(f"1000 predictions: rmse={report['rmse']:.4f} "
        f"({(time.time() - t0) * 1e3:.0f} ms)")

    # the mesh-solved mean cache becomes a durable, servable artifact: only
    # the Lanczos variance pass runs here (the tight solve is not redone),
    # then the engine restores it onto a one-device partitioned backend
    from repro_torch.core.operators import OperatorConfig, make_operator
    from repro_torch.serve import (
        PredictionEngine, load_artifact, posterior_from_mean_cache,
        save_artifact)

    op = make_operator(OperatorConfig(kernel="matern32", backend="partitioned",
                                      row_block=512), Xr, params, device=dev)
    art = posterior_from_mean_cache(
        op, a_cache, generator=torch.Generator(device=dev).manual_seed(1),
        y=y.to(dev), lanczos_rank=64, solve_rel_residual=rel[0])
    save_artifact(args.artifact, art)
    engine = PredictionEngine(load_artifact(args.artifact, device=dev),
                              chunk_size=512, device=dev)
    t0 = time.time()
    mean_e, _ = engine.predict(Xt)
    report["engine_rmse"] = float(rmse(mean_e, yt))
    say(f"engine (restored artifact): rmse={report['engine_rmse']:.4f} "
        f"({(time.time() - t0) * 1e3:.0f} ms incl. variance)")
    return report


def _rank(rank, world, store, argv):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    from repro_torch.launch.mesh import init_distributed

    args = parse_args(argv)
    init_distributed(args.device, init_method=f"file://{store}")
    run(args)


def main(argv=None) -> dict | None:
    args = parse_args(argv)
    launched = "RANK" in os.environ
    if args.device == "cpu" and not launched and args.world > 1:
        import torch.multiprocessing as mp

        with tempfile.TemporaryDirectory() as tmp:
            mp.spawn(_rank, args=(args.world, os.path.join(tmp, "store"), argv),
                     nprocs=args.world, join=True)
        return None
    return run(args)


if __name__ == "__main__":
    main()
