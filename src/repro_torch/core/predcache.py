"""Prediction-time caches (paper Section 3, "Predictions").

After training, two caches make test-time O(n):

  * mean cache  a = K_hat^{-1} y_c — one tight-tolerance PCG solve; the
    predictive mean is then mu + K_{x* X} a, one rectangular MVM.
  * variance cache — a rank-r Lanczos decomposition Q T Q^T ~= K_hat
    (LOVE-style): Var(x*) ~= k** - k_{X x*}^T Q T^{-1} Q^T k_{X x*}, an
    O(n r) product per test point, upper-bounding the exact variance;
    `predict_var_exact` is its oracle.

When observations stream in after the precomputation,
`update_prediction_cache` extends both caches to the grown system at
O(n m)-class cost per m-row batch instead of a cold precompute (the serving
fleet's `observe()`, `repro_torch.serve.fleet`).

Every function takes a `repro_torch.core.operators.KernelOperator`: the
solves use `op.matvec` (or its fused CG step), the test-time products
`op.cross_matvec`, the preconditioner `op.preconditioner`. Where the
reference draws the Lanczos start vector from a `jax.random` key, these
take the start vector `v0` or a `torch.Generator`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .kernels_math import constant_mean
from .partitioned import map_row_chunks
from .pcg import pcg
from .pivchol import Preconditioner, extend_preconditioner


def solver_dtype(op, *operands) -> torch.dtype:
    """Dtype of solver and cache state: at least fp32, whatever the
    operands (bf16 never reaches CG or Lanczos state; fp64 stays fp64)."""
    dt = op.dtype
    for a in operands:
        dt = torch.promote_types(dt, a.dtype)
    return torch.promote_types(dt, torch.float32)


def lanczos(mvm, v0: torch.Tensor, rank: int):
    """Lanczos with full reorthogonalization: Q (n, rank) and the symmetric
    tridiagonal T (rank, rank) with Q^T A Q = T. State stays in v0.dtype."""
    n = v0.shape[0]
    Q = torch.zeros((rank, n), dtype=v0.dtype, device=v0.device)
    Q[0] = v0 / torch.linalg.norm(v0)
    alphas = torch.zeros((rank,), dtype=v0.dtype, device=v0.device)
    betas = torch.zeros((rank,), dtype=v0.dtype, device=v0.device)
    for j in range(rank):
        qj = Q[j]
        w = mvm(qj[:, None])[:, 0]
        alpha = torch.dot(qj, w)
        w = w - alpha * qj
        # full reorthogonalization (rows >= j+1 are zero, contraction exact)
        w = w - Q.T @ (Q @ w)
        w = w - Q.T @ (Q @ w)  # twice is enough (Kahan)
        beta = torch.linalg.norm(w)
        alphas[j] = alpha
        if j + 1 < rank:
            Q[j + 1] = torch.where(beta > 1e-10, w / torch.clamp(beta, min=1e-30),
                                   torch.zeros_like(w))
            betas[j] = beta
    T = torch.diag(alphas) + torch.diag(betas[:-1], 1) + torch.diag(betas[:-1], -1)
    return Q.T, T


class PredictionCache(NamedTuple):
    mean_cache: torch.Tensor   # (n,) K_hat^{-1} (y - mu)
    var_Q: torch.Tensor        # (n, r)
    var_T_chol: torch.Tensor   # (r, r) Cholesky of T (+ jitter)
    solve_rel_residual: torch.Tensor  # diagnostic from the mean solve


def build_prediction_cache(
    op,
    y: torch.Tensor,
    *,
    v0: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    precond_rank: int = 100,
    lanczos_rank: int = 128,
    pred_tol: float = 0.01,
    max_cg_iters: int = 400,
) -> PredictionCache:
    """The paper's one-time precomputation: the tight mean solve and the
    Lanczos pass. Solver and cache state are at least fp32."""
    sdt = solver_dtype(op, y)
    yc = (y - constant_mean(op.params)).to(sdt)
    precond = op.preconditioner(precond_rank)
    res = pcg(op, yc[:, None], precond.solve,
              max_iters=max_cg_iters, min_iters=10, tol=pred_tol)
    Q, T_chol = build_variance_cache(op, v0=v0, generator=generator,
                                     lanczos_rank=lanczos_rank)
    return PredictionCache(res.solution[:, 0], Q, T_chol, res.rel_residual)


def build_variance_cache(op, *, v0: torch.Tensor | None = None,
                         generator: torch.Generator | None = None,
                         lanczos_rank: int = 128):
    """(Q, chol(T)) of the LOVE variance from r Lanczos MVMs. The start
    vector is `v0` if given, else a standard normal draw from `generator`
    (None = a generator on the operator's device seeded with 0)."""
    n = op.shape[0]
    r = min(lanczos_rank, n)
    sdt = solver_dtype(op)
    if v0 is None:
        if generator is None:
            generator = torch.Generator(device=op.device).manual_seed(0)
        v0 = torch.randn((n,), generator=generator, dtype=sdt, device=op.device)
    v0 = torch.as_tensor(v0, device=op.device).to(sdt)
    Q, T = lanczos(op.matvec, v0, r)
    T = T + 1e-6 * torch.eye(r, dtype=T.dtype, device=T.device)
    return Q, torch.linalg.cholesky(T)


def predict_mean(op, Xstar: torch.Tensor, cache: PredictionCache) -> torch.Tensor:
    """mu + K_{x* X} a — no solves."""
    return constant_mean(op.params) + op.cross_matvec(Xstar, cache.mean_cache)


def predict_var_cached(op, Xstar: torch.Tensor, cache: PredictionCache,
                       include_noise: bool = False) -> torch.Tensor:
    """LOVE-style O(n r) predictive variance from the Lanczos cache."""
    proj = op.cross_matvec(Xstar, cache.var_Q)                      # (n*, r)
    sol = torch.cholesky_solve(proj.T, cache.var_T_chol, upper=False)  # (r, n*)
    correction = torch.sum(proj * sol.T, dim=1)
    var = torch.clamp(op.prior_diag(Xstar) - correction, min=1e-10)
    if include_noise:
        var = var + op.noise()
    return var


def predict_var_exact(op, Xstar: torch.Tensor, *, precond_rank: int = 100,
                      pred_tol: float = 0.01, max_cg_iters: int = 400,
                      include_noise: bool = False,
                      xstar_chunk: int | None = 1024) -> torch.Tensor:
    """Exact predictive variance by PCG-solving K_hat^{-1} k_{X x*} per test
    point (mBCG columns), chunked over Xstar — the oracle of
    `predict_var_cached`."""
    precond = op.preconditioner(precond_rank)

    def one_chunk(Xc):
        Kxs = op.kernel_rows(Xc).T                                  # (n, chunk)
        res = pcg(op, Kxs.to(solver_dtype(op)), precond.solve,
                  max_iters=max_cg_iters, min_iters=10, tol=pred_tol)
        return torch.sum(Kxs * res.solution, dim=0)

    if xstar_chunk is None or Xstar.shape[0] <= xstar_chunk:
        correction = one_chunk(Xstar)
    else:
        correction = map_row_chunks(one_chunk, Xstar, xstar_chunk)
    var = torch.clamp(op.prior_diag(Xstar) - correction, min=1e-10)
    if include_noise:
        var = var + op.noise()
    return var


# ---------------------------------------------------------------------------
# incremental updates (streaming observations)
# ---------------------------------------------------------------------------


class CacheUpdateResult(NamedTuple):
    """`update_prediction_cache` output: the grown cache, the state a caller
    threads into the next batch (`precond`) and the cost diagnostics."""

    cache: PredictionCache
    precond: Preconditioner      # extended (or freshly built) preconditioner
    mean_iters: torch.Tensor     # (1,) CG iterations of the warm mean solve
    variance_refreshed: bool     # True when compaction re-ran full Lanczos
    num_new: int                 # m, appended rows this batch


def update_prediction_cache(
    op,
    y: torch.Tensor,
    cache: PredictionCache,
    *,
    v0: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    precond: Preconditioner | None = None,
    precond_rank: int = 100,
    lanczos_rank: int = 128,
    max_rank: int | None = None,
    pred_tol: float = 0.01,
    max_cg_iters: int = 400,
    min_cg_iters: int = 1,
    iter_block: int = 16,
    jitter: float = 1e-6,
) -> CacheUpdateResult:
    """Absorb m new observations into an existing prediction cache.

    `op` covers the extended inputs X_ext = [X_old; X_new] (n + m rows) at
    the hyperparameters the cache was built under, `y` is the full (n + m,)
    target vector, and `cache` covers the first n rows.

    * Mean: one PCG solve of K_hat_ext a = y_c, warm-started from the
      zero-padded previous solution, in `iter_block`-iteration blocks with a
      convergence check between them (`_pcg_blocked`), under the previous
      batch's preconditioner zero-row-extended (`extend_preconditioner`;
      pass `precond` back in) or, on the first batch, a new one.
    * Variance: with K_hat_ext = [[A, B^T], [B, C]], the Lanczos cache's
      A^{-1} ~= Q T^{-1} Q^T gives F = Q T^{-1} Q^T B^T and the Schur
      complement S = C - B F; then Q_ext = [[Q, F], [0, -I_m]] and
      T_ext = blockdiag(T, S) (`_extend_variance_cache`), one (m, n + m)
      kernel block and no solves. Once the rank would exceed `max_rank`
      (default 2 * lanczos_rank) the update compacts: a full rank-
      `lanczos_rank` Lanczos pass on the extended operator from `v0` or
      `generator` (`variance_refreshed=True`).
    """
    n_ext = int(op.shape[0])
    n_prev = int(cache.mean_cache.shape[0])
    m = n_ext - n_prev
    if m <= 0:
        raise ValueError(
            f"operator covers {n_ext} rows but the cache already covers "
            f"{n_prev} — update_prediction_cache needs at least one new row")
    sdt = solver_dtype(op, y)
    yc = (y - constant_mean(op.params)).to(sdt)

    if precond is not None:
        precond = extend_preconditioner(precond, n_ext - precond.L.shape[0])
    else:
        precond = op.preconditioner(precond_rank)

    x0 = torch.cat([cache.mean_cache.to(sdt),
                    torch.zeros((m,), dtype=sdt, device=yc.device)])
    res, mean_iters = _pcg_blocked(
        op, yc[:, None], precond, x0=x0[:, None], tol=pred_tol,
        max_iters=max_cg_iters, min_iters=min_cg_iters, block=iter_block)

    r_prev = int(cache.var_Q.shape[1])
    limit = 2 * lanczos_rank if max_rank is None else int(max_rank)
    if r_prev + m > limit:
        Q, T_chol = build_variance_cache(op, v0=v0, generator=generator,
                                         lanczos_rank=lanczos_rank)
        refreshed = True
    else:
        Q, T_chol = _extend_variance_cache(op, cache, n_prev, sdt, jitter)
        refreshed = False

    return CacheUpdateResult(
        cache=PredictionCache(res.solution[:, 0], Q, T_chol, res.rel_residual),
        precond=precond, mean_iters=mean_iters,
        variance_refreshed=refreshed, num_new=m)


def _pcg_blocked(op, B, precond, *, tol, max_iters, min_iters, block, x0):
    """PCG in `block`-iteration calls with a convergence check between them.

    Each block restarts CG from the previous block's solution, with
    `min_iters` 1 after the first block: the reference's schedule, so the
    iterates and the iteration count are its. (`pcg` itself stops early
    too, but one long call would run different iterates.)

    Returns (the last block's PCGResult, total iterations per column).
    """
    total_iters = None
    res = None
    done = 0
    while done < max_iters:
        k = min(block, max_iters - done)
        res = pcg(op, B, precond.solve, x0=x0, max_iters=k,
                  min_iters=min(min_iters, k) if done == 0 else 1, tol=tol)
        total_iters = (res.iterations if total_iters is None
                       else total_iters + res.iterations)
        done += k
        if float(torch.max(res.rel_residual)) <= tol:  # host sync per block
            break
        x0 = res.solution
    return res, total_iters


def _extend_variance_cache(op, cache: PredictionCache, n_prev: int, sdt,
                           jitter: float):
    """The blockwise (Woodbury) rank extension of the LOVE cache (see
    `update_prediction_cache`): one (m, n_ext) kernel block, no solves."""
    X_new = op.X[n_prev:]
    m = X_new.shape[0]
    dev = op.device
    eye = torch.eye(m, dtype=sdt, device=dev)
    R = op.kernel_rows(X_new).to(sdt)            # (m, n_ext), noise-free
    Bt = R[:, :n_prev].T                         # (n_prev, m) = B^T
    C = R[:, n_prev:] + (op.noise() + jitter) * eye

    Q = cache.var_Q.to(sdt)                      # (n_prev, r)
    T_chol = cache.var_T_chol.to(sdt)
    W = torch.cholesky_solve(Q.T @ Bt, T_chol, upper=False)   # (r, m)
    F = Q @ W                                    # (n_prev, m) ~= A^{-1} B^T
    S = C - Bt.T @ F
    S = 0.5 * (S + S.T) + jitter * eye
    S_chol = torch.linalg.cholesky(S)

    r = Q.shape[1]
    Q_ext = torch.cat([
        torch.cat([Q, F], dim=1),
        torch.cat([torch.zeros((m, r), dtype=sdt, device=dev), -eye], dim=1)])
    T_chol_ext = torch.cat([
        torch.cat([T_chol, torch.zeros((r, m), dtype=sdt, device=dev)], dim=1),
        torch.cat([torch.zeros((m, r), dtype=sdt, device=dev), S_chol], dim=1)])
    return Q_ext, T_chol_ext
