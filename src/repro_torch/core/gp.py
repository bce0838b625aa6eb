"""ExactGP — the paper's model on the port's operators.

The counterpart of `repro.core.gp`: hyperparameters are an explicit params
tree (GPParams for a single stationary kernel, KernelParams for a
composable spec), training lives in `repro_torch.train.gp_trainer`, and
every solve and prediction goes through a KernelOperator. Tolerances follow
the paper: loose CG (eps = 1.0) while fitting, tight (eps <= 0.01) for the
prediction caches. Randomness (SLQ probes, the Lanczos start vector) comes
from a `torch.Generator`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device import resolve_device
from .kernels_math import GPParams, KernelParams, init_params_for
from .mll import MLLConfig, exact_mll
from .operators import OperatorConfig, make_operator
from .predcache import (
    PredictionCache,
    build_prediction_cache,
    predict_mean,
    predict_var_cached,
    predict_var_exact,
)


class ExactGPConfig(NamedTuple):
    """The reference's field names and defaults."""

    kernel: str = "matern32"
    ard: bool = False                 # independent lengthscale per dim
    precond_rank: int = 100           # paper: k = 100 at large n
    num_probes: int = 8
    train_cg_tol: float = 1.0         # paper: eps = 1 suffices for training
    train_max_cg_iters: int = 100
    pred_cg_tol: float = 0.01         # paper: accurate solves at test time
    pred_max_cg_iters: int = 400
    lanczos_rank: int = 128
    row_block: int = 1024
    noise_floor: float = 1e-4
    pcg_method: str = "standard"
    backend: str = "partitioned"      # KernelOperator registry key
    compute_dtype: str | None = None  # "bfloat16" = bf16 operands
    plan: object | None = None        # SparsePlan (backend="blocksparse")
    autotune: bool = False            # autotune the pallas column split
    fused_cg: bool | None = None      # fused-CG step (None = auto)

    def mll_config(self) -> MLLConfig:
        return MLLConfig(
            kernel=self.kernel, precond_rank=self.precond_rank,
            num_probes=self.num_probes, max_cg_iters=self.train_max_cg_iters,
            cg_tol=self.train_cg_tol, row_block=self.row_block,
            noise_floor=self.noise_floor, pcg_method=self.pcg_method,
            backend=self.backend, compute_dtype=self.compute_dtype,
            plan=self.plan, autotune=self.autotune, fused_cg=self.fused_cg)

    def operator_config(self) -> OperatorConfig:
        return self.mll_config().operator_config()


class ExactGP:
    """Exact GP regression via BBMM on one device: `device` (None = the
    card; raises when there is none, at the first call that computes)."""

    def __init__(self, config: ExactGPConfig | None = None, device=None):
        self.config = config or ExactGPConfig()
        self.device = device

    def replace(self, **fields) -> "ExactGP":
        """The same model (and device) with config fields replaced."""
        return ExactGP(self.config._replace(**fields), device=self.device)

    def init_params(self, d: int, noise: float = 0.5, dtype=torch.float32
                    ) -> GPParams | KernelParams:
        """Hyperparameters matching config.kernel (GPParams for a plain
        stationary kind, KernelParams for a spec), on the model's device."""
        return init_params_for(self.config.kernel,
                               ard_dims=d if self.config.ard else None,
                               noise=noise, dtype=dtype,
                               device=resolve_device(self.device))

    def operator(self, X, params):
        """The KernelOperator every solve and prediction goes through."""
        return make_operator(self.config.operator_config(), X, params,
                             device=self.device)

    def mll(self, X, y, params, generator=None):
        """(value, aux); value is the total log marginal likelihood."""
        return exact_mll(self.config.mll_config(), X, y, params, generator,
                         device=self.device)

    def loss(self, X, y, params, generator=None):
        """Per-datum negative MLL (what the trainer minimizes)."""
        value, aux = self.mll(X, y, params, generator)
        return -value / X.shape[0], aux

    def precompute(self, X, y, params, *, v0=None,
                   generator=None) -> PredictionCache:
        c = self.config
        return build_prediction_cache(
            self.operator(X, params), y, v0=v0, generator=generator,
            precond_rank=c.precond_rank, lanczos_rank=c.lanczos_rank,
            pred_tol=c.pred_cg_tol, max_cg_iters=c.pred_max_cg_iters)

    def predict(self, X, Xstar, params, cache: PredictionCache,
                exact_variance: bool = False, include_noise: bool = True):
        c = self.config
        op = self.operator(X, params)
        mean = predict_mean(op, Xstar, cache)
        if exact_variance:
            var = predict_var_exact(
                op, Xstar, precond_rank=c.precond_rank,
                pred_tol=c.pred_cg_tol, max_cg_iters=c.pred_max_cg_iters,
                include_noise=include_noise)
        else:
            var = predict_var_cached(op, Xstar, cache,
                                     include_noise=include_noise)
        return mean, var


def rmse(pred_mean: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean((pred_mean - y_true) ** 2))


def gaussian_nll(pred_mean, pred_var, y_true) -> torch.Tensor:
    """Mean negative predictive log density (the paper's NLL column)."""
    return torch.mean(0.5 * (torch.log(2.0 * math.pi * pred_var)
                             + (y_true - pred_mean) ** 2 / pred_var))
