"""Spatial GP regression with a compactly-supported kernel on the port
(`repro_torch.sparse`). The counterpart of `examples/spatial_gp.py`.

The gp2Scale workload: 2-D spatial data, a `matern32 * wendland2` spec
whose Wendland taper gives the kernel matrix compact support, and the
`blocksparse` backend that turns that support into skipped MVM tiles (on
the card, the block-sparse CUDA kernel). Reports the plan's fill ratio,
dense-vs-blocksparse MVM timing on the same data, the trained fit, and
pruned predictions. Runs on the card unless given `--device cpu`:

    PYTHONPATH=src python examples/spatial_gp_torch.py [--device cpu] [--n 2048]

`main(argv)` returns the printed numbers.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core.gp import ExactGP, ExactGPConfig, rmse
from repro_torch.core.kernels_math import init_kernel_params, parse_kernel
from repro_torch.core.operators import OperatorConfig, make_operator
from repro_torch.device import resolve_device
from repro_torch.sparse import build_plan, spec_support_radius
from repro_torch.train.gp_trainer import GPTrainConfig, fit_exact_gp

EXPR = "matern32 * wendland2"


def make_spatial_field(n, seed=0, device=None):
    """Clustered 2-D sensor field on the unit square: 32 station clusters,
    a smooth latent surface plus observation noise (the reference's draw)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(size=(32, 2))
    X = centers[rng.integers(0, 32, n)] + 0.03 * rng.normal(size=(n, 2))
    latent = (np.sin(6.0 * X[:, 0]) * np.cos(4.0 * X[:, 1])
              + 0.5 * np.sin(9.0 * X[:, 0] * X[:, 1]))
    y = latent + 0.1 * rng.normal(size=n)
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in (X, y, latent))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' on purpose)")
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n = args.n
    X, y, latent = make_spatial_field(n, device=dev)
    ntr = int(0.8 * n)
    Xtr, ytr = X[:ntr], y[:ntr]
    Xte, lte = X[ntr:], latent[ntr:]
    print(f"spatial field: n={ntr} train / {n - ntr} test, d=2, on {dev}")

    spec = parse_kernel(EXPR)
    params = init_kernel_params(spec, noise=0.3, radius=0.15, device=dev)
    print(f"kernel: {EXPR}, support radius "
          f"{float(spec_support_radius(spec, params)):.3f}")

    # --- the plan, and what it buys on a raw MVM -------------------------
    plan = build_plan(spec, Xtr, params, tile=64)
    print(f"plan: {plan.num_tiles} tiles x {plan.tile} points, "
          f"{plan.num_pairs} active pairs -> fill={plan.fill:.3f}")

    V = torch.as_tensor(np.random.default_rng(1).normal(size=(ntr, 8)),
                        dtype=torch.float32, device=dev)
    ops = {
        "partitioned": make_operator(
            OperatorConfig(kernel=spec, backend="partitioned", row_block=64),
            Xtr, params, device=dev),
        "blocksparse": make_operator(
            OperatorConfig(kernel=spec, backend="blocksparse", plan=plan),
            Xtr, params, device=dev),
    }
    times = {}
    for name, op in ops.items():
        op.matvec(V)   # warm-up (the kernel's build on the card)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(3):
            op.matvec(V)
        _sync(dev)
        times[name] = (time.perf_counter() - t0) / 3 * 1e3
    err = float(torch.max(torch.abs(
        ops["blocksparse"].matvec(V) - ops["partitioned"].matvec(V))))
    print(f"K_hat @ V (t=8): dense-slab {times['partitioned']:.1f} ms, "
          f"pruned {times['blocksparse']:.1f} ms "
          f"({times['partitioned'] / times['blocksparse']:.1f}x at "
          f"{plan.fill:.0%} fill), max dev {err:.1e}")

    # --- train on the blocksparse backend (drift-checked replanning) ----
    gp = ExactGP(ExactGPConfig(kernel=spec, precond_rank=50, row_block=64,
                               train_max_cg_iters=50, lanczos_rank=100,
                               backend="blocksparse"), device=dev)
    res = fit_exact_gp(gp, Xtr, ytr, method="adam",
                       cfg=GPTrainConfig(plain_adam_steps=args.steps, seed=0),
                       verbose=True, device=dev)
    print(f"trained {len(res.loss_trace)} steps in {res.seconds:.1f}s "
          f"(solve modes: {[t['mode'] for t in res.telemetry]})")

    # --- predict (cross-covariance tiles pruned per query chunk) ---------
    cache = gp.precompute(Xtr, ytr, res.params,
                          generator=torch.Generator(device=dev).manual_seed(0))
    mean, var = gp.predict(Xtr, Xte, res.params, cache)
    out = {"fill": plan.fill, "mvm_max_dev": err, "times_ms": times,
           "rmse": float(rmse(mean, lte)),
           "mean_sd": float(torch.mean(torch.sqrt(var))),
           "loss_trace": [float(v) for v in res.loss_trace]}
    print(f"test rmse vs latent surface: {out['rmse']:.4f} "
          f"(mean predictive sd {out['mean_sd']:.3f})")
    return out


if __name__ == "__main__":
    main()
