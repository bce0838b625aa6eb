"""GP serving launcher: fit-or-load a posterior artifact, serve traffic.

    PYTHONPATH=src python -m repro_torch.launch.serve_gp --backend pallas \
        [--dataset houseelectric] [--n 65536] [--artifact artifacts/gp] \
        [--seed 0] [--chunk 1024] [--requests 200] [--device cuda] \
        [--scheduler continuous] [--models 2] [--workers 2] [--observe 64] \
        [--slo-target-ms 50]

The port's counterpart of `repro.launch.serve_gp`, on one device (`--device`,
default the card). Fit-or-load: a complete artifact under `--artifact` is
loaded; otherwise the launcher trains matern32 hyperparameters with
`fit_exact_gp` exactly as the reference's does (L-BFGS and Adam on a
512-point subset, two full-data Adam steps), prints them and the final
loss, runs the tight PCG mean solve and the rank-r Lanczos pass at the
trained parameters (`fit_posterior`), and saves the artifact, which the
engine is then restored from. The chunked engine is verified against the
unchunked predcache result on 512 queries (max relative error <= 1e-5 on
the fp32 path). Then `--requests` requests from `--clients` client threads
go through the chosen scheduler: `--scheduler closed` is the MicroBatcher,
`--scheduler continuous` the ServeFleet with `--models` resident
posteriors (model i > 0 refits the caches on a shrinking row subset) on
`--workers` launcher threads, with per-model p50/p99/QPS and, with
`--slo-target-ms`, breaches and burn rate. `--observe M` then absorbs M
streaming rows into model m0 through `fleet.observe()` and prices the
update against a cold refit of the caches on the same extended data.
`main()` returns what it printed as a dict.
"""

from __future__ import annotations

import argparse
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.gp import ExactGP, ExactGPConfig
from repro_torch.core.kernels_math import constant_mean, noise_variance, softplus
from repro_torch.core.operators import make_operator
from repro_torch.core.pcg import pcg
from repro_torch.core.predcache import predict_mean, predict_var_cached
from repro_torch.data.synthetic import make_regression_dataset
from repro_torch.device import resolve_device
from repro_torch.kernels.kmvm import launch_counts
from repro_torch.serve import (
    BatcherConfig, FleetConfig, MicroBatcher, PredictionEngine,
    SchedulerConfig, ServeFleet, fit_posterior, load_artifact, save_artifact,
)
from repro_torch.train.gp_trainer import GPTrainConfig, fit_exact_gp

_RESULT_TIMEOUT_S = 600.0  # a request that waits longer fails the run


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _launches_since(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in launch_counts.items()}


def fit_or_load(args, device, report: dict):
    """Load `args.artifact` if it holds a complete artifact, else train the
    hyperparameters and fit the posterior caches (saved there when given)."""
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
    gp = ExactGP(ExactGPConfig(
        kernel="matern32", backend=args.backend, row_block=512,
        precond_rank=min(100, max(20, n // 20)),
        lanczos_rank=min(128, n // 2),
        compute_dtype=args.dtype if args.dtype != "float32" else None),
        device=device)
    cfg = GPTrainConfig(pretrain_subset=min(n, 512), pretrain_lbfgs_steps=3,
                        pretrain_adam_steps=3, finetune_adam_steps=2)
    before = dict(launch_counts)
    _sync(device)
    t0 = time.perf_counter()
    res = fit_exact_gp(gp, X, y, cfg=cfg, device=device)
    _sync(device)
    p = res.params
    hyper = {"lengthscale": float(softplus(p.raw_lengthscale).max()),
             "outputscale": float(softplus(p.raw_outputscale)),
             "noise": float(noise_variance(p, gp.config.noise_floor)),
             "mean": float(constant_mean(p))}
    report.update(train_s=time.perf_counter() - t0,
                  final_loss=float(res.loss_trace[-1]), hyperparameters=hyper,
                  train_launches=_launches_since(before))
    print(f"[serve-gp] fit n={n} d={X.shape[1]} in {report['train_s']:.1f}s "
          f"(final loss {report['final_loss']:.4f}); trained matern32 "
          + " ".join(f"{k} {v:.6g}" for k, v in hyper.items()))

    c = gp.config
    before = dict(launch_counts)
    t0 = time.perf_counter()
    art = fit_posterior(
        gp.operator(X, p), y,
        generator=torch.Generator(device=device).manual_seed(0),
        precond_rank=c.precond_rank, lanczos_rank=c.lanczos_rank,
        pred_tol=c.pred_cg_tol, max_cg_iters=c.pred_max_cg_iters)
    _sync(device)
    report.update(precompute_s=time.perf_counter() - t0,
                  rel_residual=art.meta["solve_rel_residual"],
                  precond_rank=c.precond_rank, lanczos_rank=c.lanczos_rank,
                  fit_launches=_launches_since(before))
    print(f"[serve-gp] precompute {report['precompute_s']:.2f}s "
          f"rel_residual={art.meta['solve_rel_residual']:.2e} "
          f"(precond rank {c.precond_rank}, lanczos rank {c.lanczos_rank}; "
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


def _drive(predict, queries: list, clients: int) -> dict:
    """Send `queries` from `clients` threads through `predict(i, q)`; the
    reference's latency summary (`obs.latency_summary`) of the set."""
    def client(iq):
        i, q = iq
        t0 = time.perf_counter()
        mean, var = predict(i, q)
        if not (np.isfinite(mean).all() and np.isfinite(var).all()):
            raise RuntimeError("non-finite prediction")
        return time.perf_counter() - t0

    with ThreadPoolExecutor(clients) as ex:
        t0 = time.perf_counter()
        lats = np.asarray(list(ex.map(client, enumerate(queries))))
        wall = time.perf_counter() - t0
    return obs.latency_summary(lats, wall)


def _counters(batcher) -> dict:
    return dict(batches=batcher.batches_run, rows_padded=batcher.rows_padded,
                req_per_batch=batcher.requests_served
                / max(batcher.batches_run, 1))


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
    try:
        s = _drive(lambda i, q: batcher.predict(q, timeout=_RESULT_TIMEOUT_S),
                   queries, clients)
    finally:
        batcher.close()
    return dict(requests=requests, points_per_request=points_per_request,
                clients=clients, **s, **_counters(batcher))


def _make_fleet(args, art, device) -> tuple[ServeFleet, list]:
    """ServeFleet with `--models` resident posteriors: m0 is the fitted or
    loaded artifact; m{i} refits the caches on the first max(256, n - 256 i)
    rows (a distinct content digest, the same hyperparameters)."""
    arts = {"m0": art}
    base_cfg = art.config._replace(geom=None, plan=None, backend=args.backend)
    for i in range(1, args.models):
        ni = max(256, art.n - 256 * i)
        op_i = make_operator(base_cfg, art.X[:ni], art.params, device=device)
        arts[f"m{i}"] = fit_posterior(
            op_i, art.y[:ni],
            generator=torch.Generator(device=device).manual_seed(100 + i),
            precond_rank=min(100, max(10, ni // 20)),
            lanczos_rank=min(art.lanczos_rank, ni // 2))
    fleet = ServeFleet(FleetConfig(
        capacity=max(args.models, 1), chunk_size=args.chunk,
        backend=args.backend,
        scheduler=SchedulerConfig(max_batch=args.max_batch,
                                  bucket_sizes=(16, 64, args.max_batch),
                                  num_workers=args.workers),
        slo_target_ms=args.slo_target_ms), device=device)
    for name, a in arts.items():
        fleet.register(name, a)
    return fleet, list(arts)


def _observe_demo(args, art, fleet: ServeFleet, names: list, pool: np.ndarray,
                 rng: np.random.Generator, device) -> dict:
    """Absorb `--observe` rows into names[0] and price the update against a
    cold refit of the caches on the same extended data (the reference's
    comparison); also the iterations of both mean solves, the update's
    residual, the two posteriors' means on 512 queries, and how long a
    request to another model waits while the update holds the fleet."""
    name = names[0]
    m = args.observe
    Xn = pool[:m]
    mean_n, _ = fleet.predict(name, Xn, timeout=_RESULT_TIMEOUT_S)
    yn = (mean_n.reshape(-1) + 0.05 * rng.standard_normal(m)).astype(
        mean_n.dtype)
    before = dict(launch_counts)
    iters0 = obs.counter("serve.fleet.update_cg_iters").value
    started = threading.Event()

    def probe():
        """A request to another model, sent once the update has begun."""
        started.wait()
        time.sleep(0.01)
        t0 = time.perf_counter()
        fleet.predict(names[1], pool[-8:], timeout=_RESULT_TIMEOUT_S)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(1) as ex:
        waiter = ex.submit(probe) if len(names) > 1 else None
        _sync(device)
        t0 = time.perf_counter()
        started.set()
        digest = fleet.observe(name, Xn, yn)
        _sync(device)
        update_s = time.perf_counter() - t0
        lock_wait_s = waiter.result(timeout=_RESULT_TIMEOUT_S) if waiter else None
    observe_launches = _launches_since(before)
    warm_iters = obs.counter("serve.fleet.update_cg_iters").value - iters0
    updated = fleet._ensure(name).artifact

    base_cfg = art.config._replace(geom=None, plan=None, backend=args.backend)
    X_ext = torch.cat([art.X, torch.as_tensor(Xn, device=device)])
    y_ext = torch.cat([art.y, torch.as_tensor(yn, device=device)])
    op_ext = make_operator(base_cfg, X_ext, art.params, device=device)
    precond_rank = int(art.meta.get("precond_rank", 100))
    pred_tol = float(art.meta.get("pred_tol", 0.01))
    max_iters = int(art.meta.get("max_cg_iters", 400))
    _sync(device)
    t0 = time.perf_counter()
    cold = fit_posterior(op_ext, y_ext,
                         generator=torch.Generator(device=device).manual_seed(9),
                         precond_rank=precond_rank,
                         lanczos_rank=art.lanczos_rank, pred_tol=pred_tol,
                         max_cg_iters=max_iters)
    _sync(device)
    refit_s = time.perf_counter() - t0
    # the refit's mean solve once more, for its iteration count
    yc = (y_ext - constant_mean(op_ext.params))[:, None]
    cold_iters = int(pcg(op_ext, yc, op_ext.preconditioner(precond_rank).solve,
                         max_iters=max_iters, min_iters=10,
                         tol=pred_tol).iterations.max())

    Xq = pool[:512]
    mean_u, var_u = fleet.predict(name, Xq, timeout=_RESULT_TIMEOUT_S)
    mean_c = predict_mean(op_ext, torch.as_tensor(Xq, device=device),
                          cold.cache()).cpu().numpy()
    out = dict(
        m=m, model=name, digest=digest, update_s=update_s, refit_s=refit_s,
        update_vs_refit=update_s / refit_s, warm_iters=int(warm_iters),
        cold_iters=cold_iters,
        update_rel_residual=float(updated.meta["solve_rel_residual"]),
        pred_tol=pred_tol, update_rank=int(updated.meta["lanczos_rank"]),
        mean_vs_refit=float(np.max(np.abs(mean_u - mean_c))
                            / np.max(np.abs(mean_c))),
        var_finite_positive=bool(np.isfinite(var_u).all() and (var_u > 0).all()),
        observe_launches=observe_launches,
        lock_wait_ms=None if lock_wait_s is None else lock_wait_s * 1e3)
    print(f"[serve-gp] observe(m={m}) on {name}: update {update_s * 1e3:.0f} ms"
          f" vs cold refit {refit_s * 1e3:.0f} ms ({update_s / refit_s:.1%}); "
          f"CG iterations warm {warm_iters} vs cold {cold_iters}; residual "
          f"{out['update_rel_residual']:.2e}; mean vs refit "
          f"{out['mean_vs_refit']:.2e}; new digest {digest[:12]}; kernel "
          f"launches {observe_launches}"
          + ("" if lock_wait_s is None else
             f"; a request to {names[1]} waited {lock_wait_s * 1e3:.0f} ms"))
    return out


def _print_traffic(args, report: dict) -> None:
    print(f"[serve-gp] {args.requests} requests x {args.points_per_request} "
          f"pts ({args.clients} clients, backend={args.backend}, "
          f"chunk={args.chunk}, scheduler={args.scheduler}, "
          f"models={args.models}): p50={report['p50_ms']:.1f} ms "
          f"p99={report['p99_ms']:.1f} ms"
          f"{' (interpolated)' if report['p99_interpolated'] else ''} "
          f"max={report['max_ms']:.1f} ms qps={report['qps']:.1f}")
    print(f"[serve-gp] {report['batches']} device launches, "
          f"{report['req_per_batch']:.1f} req/launch, {report['rows_padded']} "
          f"padded rows")


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
                    help="closed-scheduler accumulation deadline")
    ap.add_argument("--scheduler", default="closed",
                    choices=("closed", "continuous"))
    ap.add_argument("--models", type=int, default=1,
                    help="resident posteriors (continuous scheduler only; "
                         "model i is fit on a shrinking row subset)")
    ap.add_argument("--workers", type=int, default=2,
                    help="continuous-scheduler launcher threads")
    ap.add_argument("--observe", type=int, default=0,
                    help="streaming rows to absorb via fleet.observe() "
                         "after traffic (prints update vs cold-refit cost)")
    ap.add_argument("--slo-target-ms", type=float, default=None,
                    help="per-request latency SLO (continuous scheduler): "
                         "breaches count into serve.slo_breach.<model> and "
                         "the per-model burn rate is printed")
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
    report.update(n=art.n, d=int(art.X.shape[1]), verify_rel_err=rel,
                  scheduler=args.scheduler)

    ppr = args.points_per_request
    if args.scheduler == "closed":
        traffic = serve_traffic(engine, pool, requests=args.requests,
                                points_per_request=ppr, clients=args.clients,
                                max_batch=args.max_batch,
                                max_wait_ms=args.max_wait_ms, rng=rng)
        report.update(traffic)
        _print_traffic(args, report)
    else:
        # the launcher's engine on the fleet's first queries, for the check
        # that the fleet serves what a direct engine call gives
        queries = [pool[rng.integers(0, pool.shape[0], size=ppr)]
                   for _ in range(args.requests)]
        Xc = pool[:64]
        direct = [a.cpu().numpy() for a in engine.predict(Xc)]
        fleet, names = _make_fleet(args, art, device)
        engine = None  # the fleet owns the engines now
        try:
            s = _drive(lambda i, q: fleet.predict(
                names[i % len(names)], q, timeout=_RESULT_TIMEOUT_S),
                queries, args.clients)
            report.update(requests=args.requests, points_per_request=ppr,
                          clients=args.clients, **s, **_counters(fleet.batcher))
            _print_traffic(args, report)
            mean_f, var_f = fleet.predict(names[0], Xc,
                                          timeout=_RESULT_TIMEOUT_S)
            report["fleet_vs_engine"] = {
                "mean_bitwise": bool(np.array_equal(mean_f, direct[0])),
                "mean_max_abs": float(np.max(np.abs(mean_f - direct[0]))),
                "var_rel": float(np.max(np.abs(var_f - direct[1]))
                                 / np.max(np.abs(direct[1])))}
            report["models"] = fleet.stats()
            for name, slo in sorted(report["models"].items()):
                if slo["count"]:
                    burn = (f" slo_breaches={slo['breaches']} "
                            f"burn={slo['burn_rate']:.1%}"
                            if "burn_rate" in slo else "")
                    print(f"[serve-gp]   {name}: {slo['count']} reqs "
                          f"p50={slo['p50_ms']:.1f} ms p99={slo['p99_ms']:.1f}"
                          f" ms qps={slo['qps']:.1f}{burn}")
            if args.observe:
                if art.meta.get("has_y", False):
                    report["observe"] = _observe_demo(args, art, fleet, names,
                                                     pool, rng, device)
                else:
                    print("[serve-gp] --observe skipped: artifact has no "
                          "training targets (meta['has_y'] is False)")
        finally:
            fleet.close()
    report["launches"] = dict(launch_counts)
    print(f"[serve-gp] kernel launches {report['launches']}")
    return report


if __name__ == "__main__":
    main()
