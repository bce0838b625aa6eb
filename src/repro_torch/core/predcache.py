"""Prediction-time caches (paper Section 3, "Predictions").

After training, two caches make test-time O(n):

  * mean cache  a = K_hat^{-1} y_c — one tight-tolerance PCG solve; the
    predictive mean is then mu + K_{x* X} a, one rectangular MVM.
  * variance cache — a rank-r Lanczos decomposition Q T Q^T ~= K_hat
    (LOVE-style): Var(x*) ~= k** - k_{X x*}^T Q T^{-1} Q^T k_{X x*}, an
    O(n r) product per test point, upper-bounding the exact variance;
    `predict_var_exact` is its oracle.

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
