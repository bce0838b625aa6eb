"""Stochastic Lanczos quadrature log-determinant from mBCG coefficients.

The counterpart of `repro.core.slq`. PCG on (K_hat, P) implicitly runs
Lanczos on P^{-1/2} K_hat P^{-1/2} from P^{-1/2} b; its coefficients give
the Lanczos tridiagonal T:

    T[j, j]   = 1/alpha_j + beta_{j-1}/alpha_{j-1}
    T[j, j+1] = sqrt(beta_j) / alpha_j

For probes z ~ N(0, P),

    logdet(K_hat) ~= logdet(P) + mean_i [ rz0_i * e1^T log(T_i) e1 ],

with rz0_i = z_i^T P^{-1} z_i (`PCGResult.rz0`) and logdet(P) from the
pivoted-Cholesky factor. Frozen (converged) iterations become identity rows
of T, whose log contributes 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .pcg import pcg


class SLQAux(NamedTuple):
    """Probe accounting of the standalone estimator (`slq_logdet(...,
    with_aux=True)`): per-probe CG iterations and final residuals, as
    tensors on the operator's device, for the caller to read after the
    solve."""

    iterations: torch.Tensor    # (t,) CG iterations applied per probe
    rel_residual: torch.Tensor  # (t,) final relative residual per probe
    num_probes: int


def lanczos_tridiag_from_coeffs(alphas: torch.Tensor, betas: torch.Tensor,
                                active: torch.Tensor) -> torch.Tensor:
    """The (m, m) symmetric tridiagonal T for ONE probe column from its
    (m,) CG coefficient traces; frozen iterations become identity rows."""
    one = torch.ones((), dtype=alphas.dtype, device=alphas.device)
    safe_alpha = torch.where(active, alphas, one)
    safe_alpha = torch.where(torch.abs(safe_alpha) > 1e-30, safe_alpha, one)
    prev_beta = torch.cat([torch.zeros_like(betas[:1]), betas[:-1]])
    prev_alpha = torch.cat([torch.ones_like(alphas[:1]), safe_alpha[:-1]])
    diag = torch.where(active, 1.0 / safe_alpha + prev_beta / prev_alpha, one)
    # the j <-> j+1 off-diagonal needs both iterations active
    next_active = torch.cat([active[1:], torch.zeros_like(active[:1])])
    off = torch.sqrt(torch.clamp(betas, min=0.0)) / safe_alpha
    off = torch.where(active & next_active, off, torch.zeros_like(off))[:-1]
    return torch.diag(diag) + torch.diag(off, 1) + torch.diag(off, -1)


def _e1_log_e1(T: torch.Tensor) -> torch.Tensor:
    """e1^T log(T) e1 of SPD tridiagonals T (..., m, m) via eigh."""
    evals, evecs = torch.linalg.eigh(T)
    evals = torch.clamp(evals, min=1e-10)
    return torch.sum(evecs[..., 0, :] ** 2 * torch.log(evals), dim=-1)


def slq_logdet_correction(alphas, betas, active, probe_rz0) -> torch.Tensor:
    """logdet(K_hat) - logdet(P) from the (m, t) mBCG probe traces and the
    (t,) probe norms z^T P^{-1} z."""
    T = torch.stack([
        lanczos_tridiag_from_coeffs(alphas[:, i], betas[:, i], active[:, i])
        for i in range(alphas.shape[1])])
    return torch.mean(probe_rz0 * _e1_log_e1(T))


def slq_logdet(op, generator: torch.Generator | None = None, *,
               num_probes: int = 8, precond_rank: int = 100,
               max_iters: int = 100, tol: float = 1e-8,
               method: str = "standard", with_aux: bool = False):
    """Standalone SLQ estimate of logdet(K_hat) from a KernelOperator: one
    mBCG solve on probes z ~ N(0, P) drawn from `generator`, plus
    logdet(P). With `with_aux=True`, (logdet, SLQAux)."""
    precond = op.preconditioner(precond_rank)
    probes = precond.sample(generator, num_probes, dtype=op.dtype)
    res = pcg(op, probes, precond.solve, max_iters=max_iters, min_iters=3,
              tol=tol, method=method)
    logdet = precond.logdet() + slq_logdet_correction(
        res.alphas, res.betas, res.active, res.rz0)
    if with_aux:
        return logdet, SLQAux(iterations=res.iterations,
                              rel_residual=res.rel_residual,
                              num_probes=num_probes)
    return logdet


def exact_logdet(A: torch.Tensor) -> torch.Tensor:
    """Dense reference: logdet via Cholesky. Test oracle only."""
    L = torch.linalg.cholesky(A)
    return 2.0 * torch.sum(torch.log(torch.diagonal(L)))
