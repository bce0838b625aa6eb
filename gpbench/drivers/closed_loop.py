"""Driver "closed_loop": bulk scoring against a fitted posterior.

Set-up fits the posterior at the configuration's hyperparameters with the
program's `fit_posterior` (timed as `fit_s`; the Lanczos start vector is
the benchmark's, drawn from the seed), builds the `PredictionEngine` and the
`MicroBatcher` with the mix's settings, and sends one request per client.
The window is a closed loop: `clients` threads, each sending a request of
`rows` query rows (a host numpy array from the mix's query generator,
`queries/<name>.py`, by the seed, the client and the request's index), waiting for
its mean and variance, then sending the next, until `seconds` have passed;
the window closes when the last request sent has been answered.

The check follows the program's caches (its state): the reference judges
the fit by itself (`fit_checks`: the mean cache's residual against K_hat in
float64, the Lanczos relation, orthonormality and start vector), then
computes in float64 from the caches the answers of a sample of the
window's requests, drawn from the seed, and compares each request's
answers with its own queries' (`mean_gap`, `var_gap`), which covers the
engine's chunking and ordering and the batcher's routing. The answers
against a float64 fit of the reference's own caches are read by
`controls.py --own-fit` only (PERF.md, section 2).
"""

from __future__ import annotations

import contextlib
import os
import threading

import numpy as np

from gpbench import data
from gpbench.harness import manifest, program
from gpbench.harness import trace as tracing
from gpbench.harness.output import Check
from gpbench.harness.window import Outcome, free, now, peak_bytes, reset_peak, sync
from gpbench.reference import FP64, TF32, Operator, fit_checks, \
    fit_posterior as ref_fit, served, tridiag_of

LIMITS = "serve"   # the configuration's group of limits this driver's checks use

_TIMEOUT_S = 120.0   # a request unanswered this long past the window fails


class Answers:
    """Every answer of the window, by (client, request index)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.got: dict = {}
        self.lat_ms: list = []
        self.failed = 0
        self.attempted = 0
        self.last = 0.0


def queries(cfg: dict, tr: dict):
    """The mix's query generator: `rows(pool, seed, client, k, rows)` of
    queries/<tr["queries"]>.py under the configuration's benchmark folder."""
    return manifest.load_part("queries", tr["queries"], cfg.get("bench", manifest.BENCH)).rows


def _client(batcher, qrows, pool, seed, c, rows, t_end, ans: Answers, first_k: int):
    k = first_k
    while now() < t_end:
        q = qrows(pool, seed, c, k, rows)
        t = now()
        with ans.lock:
            ans.attempted += 1
        try:
            mean, var = batcher.submit(q).result(timeout=_TIMEOUT_S)
        except Exception:  # a failed request counts in `failed`, nothing else
            with ans.lock:
                ans.failed += 1
            k += 1
            continue
        done = now()
        with ans.lock:
            ans.got[(c, k)] = (np.asarray(mean), np.asarray(var))
            ans.lat_ms.append((done - t) * 1e3)
            ans.last = max(ans.last, done)
        k += 1


def run(ctx) -> Outcome:
    import torch
    from repro_torch import obs
    from repro_torch.serve import BatcherConfig, MicroBatcher, PredictionEngine
    from repro_torch.serve import fit_posterior

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    g = cfg["gp"]
    draw = data.permuted(data.make(cfg, dev), ctx.seed)
    X, y = draw.X, draw.y
    pool = draw.pool.cpu().numpy()
    qrows = queries(cfg, tr)
    reset_peak(dev)
    raw = program.raw_leaves(cfg)
    gp = program.gp_model(cfg, dev)
    params = program.program_params(cfg, raw, dev)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed % (2 ** 63))
    v0 = torch.randn((X.shape[0],), generator=gen, device=dev)

    fault = ctx.fault() if ctx.fault else contextlib.nullcontext()
    with fault:
        op = gp.operator(X, params)
        _warm_fit(op, v0, g["lanczos_rank"])
        sync(dev)
        before = program.launches()
        t = now()
        art = fit_posterior(op, y, v0=v0, precond_rank=g["precond_rank"],
                            lanczos_rank=g["lanczos_rank"], pred_tol=g["pred_cg_tol"],
                            max_cg_iters=g["pred_max_cg_iters"])
        sync(dev)
        fit_s = now() - t
        fit_launches = program.since(before)
        engine = PredictionEngine(art, chunk_size=tr["chunk_size"], device=dev)
        batcher = MicroBatcher(engine, BatcherConfig(
            max_batch=tr["max_batch"], max_wait_ms=tr["max_wait_ms"],
            bucket_sizes=tuple(tr["bucket_sizes"])))
        try:
            warm = [batcher.submit(qrows(pool, ctx.seed, c, 0, tr["rows"]))
                    for c in range(tr["clients"])]
            for f in warm:
                f.result(timeout=_TIMEOUT_S)
            sync(dev)
            setup_s = now() - ctx.t_start

            if ctx.trace:
                obs.enable_tracing(None)
            obs.histogram("serve.predict_ms").reset()
            ans = Answers()
            before = program.launches()
            chunks0 = engine.chunks_run
            with tracing.Session(ctx.trace, os.path.join(ctx.run_dir, "trace.json")) as ts:
                t0 = now()
                threads = [threading.Thread(
                    target=_client, args=(batcher, qrows, pool, ctx.seed, c, tr["rows"],
                                          t0 + ctx.seconds, ans, 1), daemon=True)
                    for c in range(tr["clients"])]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(ctx.seconds + 2 * _TIMEOUT_S)
                sync(dev)
                t1 = max(ans.last, t0)
            launched = program.since(before)
            engine_ms = obs.histogram("serve.predict_ms").percentiles((50,))[0]
            if ctx.trace:
                obs.drain_events()
                obs.disable_tracing(snapshot_metrics=False)
            chunks = engine.chunks_run - chunks0
        finally:
            batcher.close()
    peak = peak_bytes(dev)
    if any(th.is_alive() for th in threads):
        raise RuntimeError("a client thread did not finish")
    done = len(ans.got)
    rows = done * tr["rows"]
    lat = np.asarray(ans.lat_ms)
    e2e = {"setup_s": setup_s, "fit_s": fit_s,
           "predict_rows_per_s": rows / (t1 - t0),
           "predict_p95_ms": float(np.percentile(lat, 95)) if lat.size else float("nan")}
    records = {"window_s": t1 - t0, "requests": done, "rows": tr["rows"],
               "launches": launched, "fit_launches": fit_launches,
               "lanczos_rank": g["lanczos_rank"], "chunks": chunks,
               "chunk_size": tr["chunk_size"], "engine_ms_p50": engine_ms,
               "predict_p95_ms": e2e["predict_p95_ms"],
               "profile": ts.result, "factors": cfg["factors"],
               "shape": {"n": X.shape[0], "d": X.shape[1], "r": g["lanczos_rank"]},
               "support": cfg.get("support_radius")}
    if ctx.trace and cfg.get("support_radius"):
        records["pairs"] = _pairs(X, qrows, pool, ctx.seed, sorted(ans.got), tr["rows"],
                                  cfg["support_radius"])
    caches = (art.mean_cache.detach(), art.var_Q.detach(), art.var_T_chol.detach(),
              float(art.solve_rel_residual.max()))
    del engine, batcher, op, art, gp, params
    free(dev)
    if ctx.capture is not None:
        ctx.capture.update(cfg=cfg, tr=tr, X=X, y=y, v0=v0, caches=caches,
                           pool=pool, got=ans.got, seed=ctx.seed)
    checks = serving_checks(cfg, tr, X, y, v0, caches, pool, ans, ctx.seed,
                            cfg["limits"][LIMITS])
    return Outcome(ans.attempted, ans.failed, e2e, records, checks, peak)


def _warm_fit(op, v, r: int) -> None:
    """The fit's kinds of work once, so that `fit_s` times the fit and not a
    library's first call: a kernel MVM, the fused CG step where the
    operator has one, a small preconditioner, the (r, r) factorization."""
    import torch

    V = v[:, None]
    op.matvec(V)
    if getattr(op, "supports_fused_step", False):
        op.fused_matvec_dots(V, V)
    op.preconditioner(2).solve(V)
    T = torch.eye(r, dtype=v.dtype, device=v.device)
    torch.cholesky_solve(T[:, :1], torch.linalg.cholesky(T))


def _pairs(X, qrows, pool, seed, keys, rows, radius) -> dict:
    """Over the window's requests: the (query, training point) pairs within
    the support radius, and per request the training points any of its
    queries needs, summed."""
    import torch

    pairs, needed = 0, 0
    for c, k in keys:
        Z = torch.as_tensor(qrows(pool, seed, c, k, rows), device=X.device)
        need = torch.zeros(X.shape[0], dtype=torch.bool, device=X.device)
        for i in range(0, Z.shape[0], 1024):
            inside = torch.cdist(Z[i:i + 1024], X) < radius
            pairs += int(inside.sum())
            need |= inside.any(0)
        needed += int(need.sum())
    return {"pairs": pairs, "needed": needed}


def sample_keys(keys: list, seed: int, count: int) -> list:
    """A sample of the answered requests drawn from the seed."""
    keys = sorted(keys)
    rng = np.random.default_rng([seed % (2 ** 63), 7])
    pick = rng.choice(len(keys), size=min(count, len(keys)), replace=False)
    return [keys[i] for i in sorted(pick)]


def judge_answers(op_ref: Operator, qrows, pool, seed, rows, keys, got, caches) -> dict:
    """`mean_gap`: the largest |mean - reference| over the sample, over the
    largest |reference - mu|; `var_gap`: the largest relative variance
    error."""
    import torch

    c, Q, T_chol = caches[:3]
    mg, vg, scale = 0.0, 0.0, 0.0
    for key in keys:
        Z = torch.as_tensor(qrows(pool, seed, *key, rows), device=c.device)
        m_ref, v_ref = served(op_ref, Z, c, Q, T_chol)
        m, v = (torch.as_tensor(a, device=c.device, dtype=torch.float64) for a in got[key])
        mg = max(mg, float(torch.max(torch.abs(m - m_ref))))
        scale = max(scale, float(torch.max(torch.abs(m_ref - op_ref.kern.mean))))
        vg = max(vg, float(torch.max(torch.abs(v - v_ref) / v_ref)))
    return {"mean_gap": mg / scale, "var_gap": vg}


def serving_checks(cfg, tr, X, y, v0, caches, pool, ans: Answers, seed,
                   limits) -> list:
    """Judge the program's caches and a sample of its answers in float64."""
    ref = _ref_op(cfg, X, FP64)
    keys = sample_keys(list(ans.got), seed, tr["check_requests"])
    nums = numbers(cfg, tr, ref, y, v0, caches, pool, seed, keys, ans.got)
    return [Check(k, nums[k], limit) for k, limit in limits.items()]


def numbers(cfg, tr, ref, y, v0, caches, pool, seed, keys, got) -> dict:
    """Every number of a fit and its answers: `fit_residual`, the mean
    solve's relative residual as the fit reports it (the configuration's
    tolerance is its limit), and those of `fit_checks` and
    `judge_answers`."""
    c, Q, T_chol, claimed = caches
    nums = fit_checks(ref, y, c, Q, tridiag_of(T_chol), v0, claimed, cfg["gp"]["pred_cg_tol"])
    nums["fit_residual"] = claimed
    nums.update(judge_answers(ref, queries(cfg, tr), pool, seed, tr["rows"], keys, got,
                              caches))
    return nums


def _ref_op(cfg, X, prec, dense_limit: int = 0):
    return Operator(program.ref_kernel(cfg, program.raw_leaves(cfg)), X, prec,
                    dense_limit=dense_limit)


def controls(cap: dict, full: bool = True, own_fit: bool = False) -> dict:
    """`program`: every number of the captured run; with `full`, the
    stand-ins' readings too (`stand_ins`); with `own_fit`, the answers
    against a float64 fit of the reference's own caches (`own`)."""
    cfg, tr, X, y, v0, caches, pool, got, seed = (
        cap[k] for k in ("cfg", "tr", "X", "y", "v0", "caches", "pool", "got", "seed"))
    keys = sample_keys(list(got), seed, tr["check_requests"])
    ref = _ref_op(cfg, X, FP64)
    out = {"program": numbers(cfg, tr, ref, y, v0, caches, pool, seed, keys, got)}
    del ref
    if full:
        out.update(stand_ins(cfg, tr, X, y, v0, caches, pool, seed, keys, got,
                             own_fit=own_fit))
    return out


def _fit(op, y, v0, g):
    return ref_fit(op, y, v0, precond_rank=g["precond_rank"], lanczos_rank=g["lanczos_rank"],
                   tol=g["pred_cg_tol"], max_iters=g["pred_max_cg_iters"])


def _answers(op, qrows, pool, seed, rows, keys, c, Q, T_chol) -> dict:
    """The sample's (mean, var) from caches (c, Q, T_chol) at op's precision."""
    import torch

    out = {}
    for k in keys:
        Z = torch.as_tensor(qrows(pool, seed, *k, rows), device=c.device)
        out[k] = tuple(a.cpu().numpy() for a in served(op, Z, c, Q, T_chol))
    return out


def stand_ins(cfg, tr, X, y, v0, caches, pool, seed, keys, got, own_fit=False) -> dict:
    """Readings when the reference at TF32 takes the program's place, stage
    by stage (`tf32`): it fits its own caches, judged by the fit's numbers
    (a tridiagonal that is not positive definite still has its Lanczos
    relation read), and answers the sample from the program's caches,
    judged by the answers' numbers. With `own_fit` (`own`): the reference
    fits its own caches in float64 from the same start vector and answers
    the sample from them; the program's answers and the TF32 stand-in's
    answers from its own caches are held against those (`mean_gap`,
    `var_gap` as `judge_answers` reads them)."""
    import torch

    g, tol = cfg["gp"], cfg["gp"]["pred_cg_tol"]
    qrows = queries(cfg, tr)
    ref = _ref_op(cfg, X, FP64)
    op_t = _ref_op(cfg, X, TF32)
    c, Q, T, claimed = _fit(op_t, y, v0, g)
    out = fit_checks(ref, y, c, Q, T, v0, claimed, tol)
    out["fit_residual"] = claimed
    ctl_got = _answers(op_t, qrows, pool, seed, tr["rows"], keys, *caches[:3])
    out.update(judge_answers(ref, qrows, pool, seed, tr["rows"], keys, ctl_got, caches))
    res = {"tf32": out}
    if own_fit:
        eye = torch.eye(Q.shape[1], dtype=T.dtype, device=T.device)
        try:
            own_t = _answers(op_t, qrows, pool, seed, tr["rows"], keys, c, Q,
                             torch.linalg.cholesky(T + 1e-6 * eye))
        except RuntimeError:   # a tridiagonal that is not positive definite
            own_t = None
        c64, Q64, T64, _ = _fit(ref, y, v0, g)
        caches64 = (c64, Q64, torch.linalg.cholesky(T64 + 1e-6 * eye.to(T64.dtype)))
        judge = lambda ans: judge_answers(ref, qrows, pool, seed, tr["rows"], keys, ans,
                                          caches64)
        res["own"] = {"program": judge(got),
                      "tf32": judge(own_t) if own_t is not None else
                      {"mean_gap": float("inf"), "var_gap": float("inf")}}
    del op_t, c, Q, T
    free(X.device)
    return res
