"""SGPR — Sparse Gaussian Process Regression (Titsias 2009), paper baseline.

The counterpart of `repro.core.sgpr`. The collapsed variational bound over
m inducing points Z:

    ELBO = log N(y | mu, Q_nn + s2 I) - tr(K_nn - Q_nn) / (2 s2),
    Q_nn = K_nm K_mm^{-1} K_mn.

Numerically stable form (Matthews 2016 / GPflow), as the reference:
    L  = chol(K_mm + jitter I)
    A  = L^{-1} K_mn / s                      (m, n)
    B  = I + A A^T,  LB = chol(B)
    c  = LB^{-1} A yc / s
    ELBO = -n/2 log 2pi - sum log diag(LB) - n/2 log s2
           - ||yc||^2/(2 s2) + ||c||^2/2 - (sum k_ii - s2 ||A||_F^2)/(2 s2)

O(n m^2) time, O(n m) memory. Z is a free variational parameter optimized
with the hyperparameters (the paper: m = 512). The kernel matrices are
dense `kernel_matrix` tensors and the factorizations library calls, as in
the reference (which reaches no Pallas kernel here). A Cholesky that fails
gives NaNs, as `jnp.linalg.cholesky` does, so a failed factorization shows
as a non-finite loss rather than an exception or a silent repair.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device import resolve_device
from .kernels_math import (
    GPParams,
    constant_mean,
    init_params,
    kernel_diag,
    kernel_matrix,
    noise_variance,
)

_JITTER = 1e-6


class SGPRParams(NamedTuple):
    gp: GPParams
    Z: torch.Tensor  # (m, d) inducing points


def cholesky_or_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of A, all NaN where the factorization fails
    (the reference's `jnp.linalg.cholesky`); no host sync."""
    L, info = torch.linalg.cholesky_ex(A)
    return L.masked_fill(info != 0, float("nan"))


def _solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """L^{-1} B for lower-triangular L; B a vector or a matrix."""
    if B.ndim == 1:
        return torch.linalg.solve_triangular(L, B[:, None], upper=False)[:, 0]
    return torch.linalg.solve_triangular(L, B, upper=False)


def inducing_subset(X, num_inducing: int, generator: torch.Generator | None,
                    dtype, device) -> torch.Tensor:
    """A random subset of X's rows (with replacement only when m > n), as
    `jax.random.choice` draws the reference's; generator None = seed 0."""
    dev = resolve_device(device)
    X = torch.as_tensor(X, device=dev)
    n = X.shape[0]
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if num_inducing > n:
        idx = torch.randint(0, n, (num_inducing,), generator=generator,
                            device=dev)
    else:
        idx = torch.randperm(n, generator=generator, device=dev)[:num_inducing]
    return X[idx].to(dtype)


def init_sgpr_params(X, num_inducing: int, ard_dims: int | None = None,
                     noise: float = 0.5, dtype=torch.float32, *,
                     generator: torch.Generator | None = None,
                     device=None) -> SGPRParams:
    """Inducing points initialized as a random training subset (standard).
    `generator` takes the place of the reference's key; device None = the
    card."""
    Z = inducing_subset(X, num_inducing, generator, dtype, device)
    return SGPRParams(gp=init_params(ard_dims=ard_dims, noise=noise,
                                     dtype=dtype, device=Z.device), Z=Z)


def _common(kind, X, params: SGPRParams, noise_floor):
    m = params.Z.shape[0]
    s2 = noise_variance(params.gp, noise_floor)
    Kmm = kernel_matrix(kind, params.Z, params.Z, params.gp)
    Kmm = Kmm + _JITTER * torch.eye(m, dtype=Kmm.dtype, device=Kmm.device)
    L = cholesky_or_nan(Kmm)
    Kmn = kernel_matrix(kind, params.Z, X, params.gp)
    A = _solve_lower(L, Kmn) / torch.sqrt(s2)
    B = torch.eye(m, dtype=A.dtype, device=A.device) + A @ A.T
    LB = cholesky_or_nan(B)
    return s2, L, A, LB


def sgpr_elbo(kind: str, X, y, params: SGPRParams, noise_floor: float = 1e-4):
    """Collapsed bound (total, not per-datum)."""
    n = X.shape[0]
    yc = y - constant_mean(params.gp)
    s2, L, A, LB = _common(kind, X, params, noise_floor)
    c = _solve_lower(LB, A @ yc) / torch.sqrt(s2)
    kdiag_sum = torch.sum(kernel_diag(kind, X, params.gp))
    return (
        -0.5 * n * math.log(2.0 * math.pi)
        - torch.sum(torch.log(torch.diagonal(LB)))
        - 0.5 * n * torch.log(s2)
        - 0.5 * torch.dot(yc, yc) / s2
        + 0.5 * torch.dot(c, c)
        - 0.5 * (kdiag_sum / s2 - torch.sum(A * A))
    )


def sgpr_loss(kind: str, X, y, params: SGPRParams, noise_floor: float = 1e-4):
    return -sgpr_elbo(kind, X, y, params, noise_floor) / X.shape[0]


class SGPRCache(NamedTuple):
    L: torch.Tensor    # (m, m)
    LB: torch.Tensor   # (m, m)
    c: torch.Tensor    # (m,)


def sgpr_precompute(kind: str, X, y, params: SGPRParams,
                    noise_floor: float = 1e-4) -> SGPRCache:
    yc = y - constant_mean(params.gp)
    s2, L, A, LB = _common(kind, X, params, noise_floor)
    c = _solve_lower(LB, A @ yc) / torch.sqrt(s2)
    return SGPRCache(L=L, LB=LB, c=c)


def sgpr_predict(kind: str, Xstar, params: SGPRParams, cache: SGPRCache,
                 noise_floor: float = 1e-4, include_noise: bool = True):
    """Predictive mean/variance at Xstar from the cached factors. O(n* m^2)."""
    Ks = kernel_matrix(kind, params.Z, Xstar, params.gp)       # (m, n*)
    tmp1 = _solve_lower(cache.L, Ks)
    tmp2 = _solve_lower(cache.LB, tmp1)
    mean = constant_mean(params.gp) + tmp2.T @ cache.c
    kss = kernel_diag(kind, Xstar, params.gp)
    var = kss - torch.sum(tmp1 * tmp1, dim=0) + torch.sum(tmp2 * tmp2, dim=0)
    var = torch.clamp(var, min=1e-10)
    if include_noise:
        var = var + noise_variance(params.gp, noise_floor)
    return mean, var
