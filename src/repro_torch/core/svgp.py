"""SVGP — Stochastic Variational GP (Hensman et al. 2013), paper baseline.

The counterpart of `repro.core.svgp`. Whitened parameterization:
q(u~) = N(m~, S~), u = L_mm u~ with L_mm = chol(K_mm). The minibatch ELBO
for a Gaussian likelihood:

    ELBO = (n/|b|) sum_{i in b} [ log N(y_i | mu_i, s2) - v_i / (2 s2) ]
           - KL( N(m~, S~) || N(0, I) )
    mu_i = a_i^T m~,  v_i = k_ii - ||a_i||^2 + ||S~^{1/2 T} a_i||^2,
    a_i  = L_mm^{-1} k(Z, x_i)

S~ is parameterized by its Cholesky factor (diagonal softplus'd). The paper
trains SVGP with m = 1024, Adam(0.01), batch 1024, 100 epochs. As in
`core/sgpr.py`, the matrices are dense library calls and a failed Cholesky
gives NaNs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .kernels_math import (
    GPParams,
    constant_mean,
    init_params,
    kernel_diag,
    kernel_matrix,
    noise_variance,
    softplus,
)
from .sgpr import _solve_lower, cholesky_or_nan, inducing_subset

_JITTER = 1e-6


class SVGPParams(NamedTuple):
    gp: GPParams
    Z: torch.Tensor           # (m, d) inducing points
    q_mu: torch.Tensor        # (m,) whitened variational mean
    q_sqrt_raw: torch.Tensor  # (m, m) lower-tri factor; diagonal through softplus


def init_svgp_params(X, num_inducing: int, ard_dims: int | None = None,
                     noise: float = 0.5, dtype=torch.float32, *,
                     generator: torch.Generator | None = None,
                     device=None) -> SVGPParams:
    """Inducing points a random training subset, q_mu = 0, q_sqrt = I.
    `generator` takes the place of the reference's key; device None = the
    card."""
    Z = inducing_subset(X, num_inducing, generator, dtype, device)
    m = num_inducing
    # q_sqrt ~= I: softplus(raw_diag) = 1  =>  raw = inv_softplus(1) = 0.5413
    raw = torch.diag(torch.full((m,), 0.54132485, dtype=dtype,
                                device=Z.device))
    return SVGPParams(
        gp=init_params(ard_dims=ard_dims, noise=noise, dtype=dtype,
                       device=Z.device),
        Z=Z,
        q_mu=torch.zeros((m,), dtype=dtype, device=Z.device),
        q_sqrt_raw=raw,
    )


def _q_sqrt(params: SVGPParams) -> torch.Tensor:
    lower = torch.tril(params.q_sqrt_raw, -1)
    diag = softplus(torch.diagonal(params.q_sqrt_raw))
    return lower + torch.diag(diag)


def _kl_whitened(q_mu, q_sqrt):
    """KL( N(q_mu, q_sqrt q_sqrt^T) || N(0, I) )."""
    m = q_mu.shape[0]
    logdet_q = 2.0 * torch.sum(torch.log(torch.diagonal(q_sqrt)))
    trace = torch.sum(q_sqrt * q_sqrt)
    return 0.5 * (trace + torch.dot(q_mu, q_mu) - m - logdet_q)


def _whitened_cross(kind, Xb, params: SVGPParams):
    """A = L_mm^{-1} K(Z, Xb), with L_mm = chol(K_mm + jitter I)."""
    m = params.q_mu.shape[0]
    Kmm = kernel_matrix(kind, params.Z, params.Z, params.gp)
    Kmm = Kmm + _JITTER * torch.eye(m, dtype=Kmm.dtype, device=Kmm.device)
    L = cholesky_or_nan(Kmm)
    return _solve_lower(L, kernel_matrix(kind, params.Z, Xb, params.gp))


def svgp_elbo(kind: str, Xb, yb, params: SVGPParams, n_total: int,
              noise_floor: float = 1e-4):
    """Minibatch ELBO estimate (total over the dataset)."""
    b = Xb.shape[0]
    s2 = noise_variance(params.gp, noise_floor)
    q_sqrt = _q_sqrt(params)
    A = _whitened_cross(kind, Xb, params)                       # (m, b)

    mu = A.T @ params.q_mu + constant_mean(params.gp)
    SA = q_sqrt.T @ A                                            # (m, b)
    kdiag = kernel_diag(kind, Xb, params.gp)
    v = torch.clamp(kdiag - torch.sum(A * A, 0) + torch.sum(SA * SA, 0),
                    min=1e-10)

    expected_ll = (
        -0.5 * math.log(2.0 * math.pi) - 0.5 * torch.log(s2)
        - 0.5 * ((yb - mu) ** 2 + v) / s2
    )
    scale = n_total / b
    return scale * torch.sum(expected_ll) - _kl_whitened(params.q_mu, q_sqrt)


def svgp_loss(kind: str, Xb, yb, params: SVGPParams, n_total: int,
              noise_floor: float = 1e-4):
    return -svgp_elbo(kind, Xb, yb, params, n_total, noise_floor) / n_total


def svgp_predict(kind: str, Xstar, params: SVGPParams,
                 noise_floor: float = 1e-4, include_noise: bool = True):
    """q(f*) moments; O(n* m^2), no training-set access at test time."""
    q_sqrt = _q_sqrt(params)
    A = _whitened_cross(kind, Xstar, params)
    mean = A.T @ params.q_mu + constant_mean(params.gp)
    SA = q_sqrt.T @ A
    kss = kernel_diag(kind, Xstar, params.gp)
    var = torch.clamp(kss - torch.sum(A * A, 0) + torch.sum(SA * SA, 0),
                      min=1e-10)
    if include_noise:
        var = var + noise_variance(params.gp, noise_floor)
    return mean, var
