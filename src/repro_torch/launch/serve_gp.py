"""GP serving launcher: fit-or-load a posterior artifact, serve traffic.

    PYTHONPATH=src python -m repro_torch.launch.serve_gp --backend pallas \
        [--dataset houseelectric] [--n 262144] [--artifact artifacts/gp] \
        [--seed 0] [--chunk 1024] [--requests 200] [--device cuda]

The port's counterpart of `repro.launch.serve_gp`, on one device (`--device`,
default the card). "Fit" here means `fit_posterior` at FIXED
hyperparameters — hyperparameter training is not ported yet: the ones of a
loaded artifact, or matern32 with lengthscale sqrt(d) (the data
generator's own), outputscale 1 and noise 0.01, printed at start. The fit
runs the tight PCG mean solve and the rank-r Lanczos pass; with
`--artifact` the posterior is saved and the engine is restored from the
saved copy. The chunked engine is verified against the unchunked predcache
result on 512 queries (max relative error <= 1e-5 on the fp32 path), then
`--requests` requests from `--clients` client threads go through the
MicroBatcher, and p50/p99 latency and QPS are reported.
"""

from __future__ import annotations

import argparse
import math
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core.kernels_math import init_params
from repro_torch.core.operators import OperatorConfig, make_operator
from repro_torch.core.predcache import predict_mean, predict_var_cached
from repro_torch.data.synthetic import make_regression_dataset
from repro_torch.device import resolve_device
from repro_torch.kernels.kmvm import launch_counts
from repro_torch.serve import (
    BatcherConfig, MicroBatcher, PredictionEngine, fit_posterior,
    load_artifact, save_artifact,
)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit_or_load(args, device, report: dict):
    """Load `args.artifact` if it holds a complete artifact, else fit one at
    fixed hyperparameters (and save it there when given)."""
    if args.artifact:
        try:
            art = load_artifact(args.artifact, device=device)
            print(f"[serve-gp] loaded artifact: n={art.n} r={art.lanczos_rank} "
                  f"from {args.artifact}")
            return art
        except FileNotFoundError:
            print(f"[serve-gp] no artifact under {args.artifact!r}; fitting")

    s = make_regression_dataset(args.dataset, seed=args.seed,
                                max_points=args.n * 9 // 4)
    n = min(args.n, s.X_train.shape[0])
    X = torch.as_tensor(s.X_train[:n], dtype=torch.float32, device=device)
    y = torch.as_tensor(s.y_train[:n], dtype=torch.float32, device=device)
    d = X.shape[1]
    # the launcher's hyperparameters until training is ported
    params = init_params(lengthscale=math.sqrt(d), outputscale=1.0, noise=0.01,
                         device=device)
    print(f"[serve-gp] fixed hyperparameters: matern32 lengthscale "
          f"{math.sqrt(d):.6g} outputscale 1.0 noise 0.01 (n={n} d={d})")
    op = make_operator(OperatorConfig(kernel="matern32", backend=args.backend),
                       X, params, device=device)
    precond_rank = min(100, max(20, n // 20))
    lanczos_rank = min(128, n // 2)
    _sync(device)
    t0 = time.perf_counter()
    art = fit_posterior(op, y, precond_rank=precond_rank,
                        lanczos_rank=lanczos_rank, pred_tol=0.01,
                        max_cg_iters=400)
    _sync(device)
    report.update(precompute_s=time.perf_counter() - t0,
                  rel_residual=art.meta["solve_rel_residual"],
                  precond_rank=precond_rank, lanczos_rank=lanczos_rank,
                  fit_launches=dict(launch_counts))
    print(f"[serve-gp] precompute {report['precompute_s']:.2f}s "
          f"rel_residual={art.meta['solve_rel_residual']:.2e} "
          f"(precond rank {precond_rank}, lanczos rank {lanczos_rank}; "
          f"kernel launches {report['fit_launches']})")
    if args.artifact:
        print(f"[serve-gp] saved artifact: {save_artifact(args.artifact, art)}")
        art = load_artifact(args.artifact, device=device)
    return art


def verify(engine: PredictionEngine, Xq: torch.Tensor) -> float:
    """Max relative error of the chunked engine against the unchunked
    predcache result on the same operator (the acceptance oracle)."""
    mean, var = engine.predict(Xq)
    cache = engine.artifact.cache()
    ref_m = predict_mean(engine.op, Xq, cache)
    ref_v = predict_var_cached(engine.op, Xq, cache,
                               include_noise=engine.include_noise)
    return max(
        float(torch.max(torch.abs(mean - ref_m)) / torch.max(torch.abs(ref_m))),
        float(torch.max(torch.abs(var - ref_v)) / torch.max(torch.abs(ref_v))))


def serve_traffic(engine: PredictionEngine, pool: np.ndarray, *,
                  requests: int, points_per_request: int, clients: int,
                  max_batch: int = 128, max_wait_ms: float = 2.0,
                  rng: np.random.Generator | None = None) -> dict:
    """`requests` requests of `points_per_request` rows drawn from `pool`,
    sent by `clients` threads through a MicroBatcher over `engine`: latency
    p50/p99/max (ms), QPS, batches, requests per batch, padded rows."""
    rng = np.random.default_rng(0) if rng is None else rng
    queries = [pool[rng.integers(0, pool.shape[0], size=points_per_request)]
               for _ in range(requests)]
    batcher = MicroBatcher(engine, BatcherConfig(
        max_batch=max_batch, max_wait_ms=max_wait_ms,
        bucket_sizes=(16, 64, max_batch)))

    def client(q):
        t0 = time.perf_counter()
        mean, var = batcher.predict(q)
        if not (np.isfinite(mean).all() and np.isfinite(var).all()):
            raise RuntimeError("non-finite prediction")
        return time.perf_counter() - t0

    try:
        with ThreadPoolExecutor(clients) as ex:
            t0 = time.perf_counter()
            lats = np.asarray(list(ex.map(client, queries)))
            wall = time.perf_counter() - t0
    finally:
        batcher.close()
    return dict(
        requests=requests, points_per_request=points_per_request,
        clients=clients, p50_ms=float(np.percentile(lats, 50) * 1e3),
        p99_ms=float(np.percentile(lats, 99) * 1e3),
        max_ms=float(lats.max() * 1e3), qps=requests / wall,
        batches=batcher.batches_run, rows_padded=batcher.rows_padded,
        req_per_batch=batcher.requests_served / max(batcher.batches_run, 1))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="pallas",
                    choices=("dense", "partitioned", "pallas"))
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="engine cross-MVM compute dtype")
    ap.add_argument("--dataset", default="bike")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the dataset draw")
    ap.add_argument("--n", type=int, default=2048, help="train points to fit")
    ap.add_argument("--artifact", default="",
                    help="artifact dir: load if complete, else fit + save")
    ap.add_argument("--chunk", type=int, default=256,
                    help="engine test-set chunk (rows per launch)")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--points-per-request", type=int, default=8)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=128)
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="batcher accumulation deadline")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' on purpose)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the launcher; returns what it printed as a dict."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    report: dict = {}
    art = fit_or_load(args, device, report)
    engine = PredictionEngine(
        art, backend=args.backend, chunk_size=args.chunk, device=device,
        compute_dtype=args.dtype if args.dtype != "float32" else None)
    engine.warmup()

    rng = np.random.default_rng(0)
    # query pool: train-point perturbations (in-distribution traffic)
    X_host = art.X.cpu().numpy()
    pool = X_host[rng.integers(0, art.n, size=2048)]
    pool = pool + 0.1 * rng.standard_normal(pool.shape).astype(pool.dtype)

    rel = verify(engine, torch.as_tensor(pool[:512], device=device))
    exact_path = engine.config.compute_dtype is None
    print(f"[serve-gp] engine vs unchunked reference: max rel err {rel:.2e} "
          f"({'exact fp32 path, bound 1e-5' if exact_path else 'bf16 path'})")
    if exact_path and not rel <= 1e-5:
        raise SystemExit(f"verification FAILED: rel err {rel:.2e} > 1e-5")

    ppr = args.points_per_request
    traffic = serve_traffic(engine, pool, requests=args.requests,
                            points_per_request=ppr, clients=args.clients,
                            max_batch=args.max_batch,
                            max_wait_ms=args.max_wait_ms, rng=rng)
    report.update(n=art.n, d=int(art.X.shape[1]), verify_rel_err=rel,
                  **traffic, launches=dict(launch_counts))
    print(f"[serve-gp] {args.requests} requests x {ppr} pts ({args.clients} "
          f"clients, backend={args.backend}, chunk={args.chunk}): "
          f"p50={report['p50_ms']:.1f} ms p99={report['p99_ms']:.1f} ms "
          f"max={report['max_ms']:.1f} ms qps={report['qps']:.1f}")
    print(f"[serve-gp] {report['batches']} device batches, "
          f"{report['req_per_batch']:.1f} req/batch, {report['rows_padded']} "
          f"padded rows; kernel launches {dict(launch_counts)}")
    return report


if __name__ == "__main__":
    main()
