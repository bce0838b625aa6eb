"""BBMM exact GP log marginal likelihood with a hand-written backward.

The counterpart of `repro.core.mll`. Forward (paper Eq. 1): one mBCG call
solves K_hat^{-1}[y_c, z_1..z_t] and yields the SLQ log-determinant:

    mll = -0.5 * ( y_c^T K_hat^{-1} y_c + logdet(K_hat) + n log 2pi ).

Backward (paper Eq. 2): the saved solves are contracted against dK/dtheta
through the operator's bounded-memory quadratic-form gradient
(`KernelOperator.quad_form_grads`), never by differentiating through the
CG iterations:

    d/dth [ y^T K^-1 y ] = - u_y^T (dK/dth) u_y,           u_y = K^{-1} y_c
    d/dth [ logdet K ]  ~=   mean_i u_i^T (dK/dth) (P^{-1} z_i),

for z_i ~ N(0, P). `exact_mll` wraps the pair as a `torch.autograd.Function`
whose gradients flow to the hyperparameters, X and y. Probes come from a
`torch.Generator` (or are injected: `operator_mll_forward(probes=)`); the
reference draws them from a jax key, so parity tests inject the same
probes into both. The backward always contracts in full precision, even
after a bf16-compute forward.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import obs
from ..device import resolve_device
from .kernels_math import (
    constant_mean,
    dense_khat,
    params_leaves,
    params_map,
    params_unflatten,
)
from .operators import OperatorConfig, backward_backend_for, make_operator
from .pcg import pcg
from .slq import slq_logdet_correction


class MLLConfig(NamedTuple):
    """Solver configuration, with the reference's field names."""

    kernel: str = "matern32"
    precond_rank: int = 100
    num_probes: int = 8
    max_cg_iters: int = 100
    min_cg_iters: int = 3
    cg_tol: float = 1.0
    row_block: int = 1024
    noise_floor: float = 1e-4
    pcg_method: str = "standard"
    backend: str = "partitioned"          # operator registry key
    compute_dtype: str | None = None      # "bfloat16" = bf16 operands
    plan: object | None = None            # SparsePlan (backend="blocksparse")
    autotune: bool = False                # autotune the pallas column split
    fused_cg: bool | None = None          # fused-CG step (None = auto)

    def operator_config(self) -> OperatorConfig:
        return OperatorConfig(
            kernel=self.kernel, backend=self.backend, row_block=self.row_block,
            add_noise=True, noise_floor=self.noise_floor,
            compute_dtype=self.compute_dtype, plan=self.plan,
            autotune=self.autotune, fused_cg=self.fused_cg)


class MLLAux(NamedTuple):
    """Diagnostics (no gradients flow through these)."""

    logdet: torch.Tensor
    quad: torch.Tensor
    cg_iterations: torch.Tensor
    rel_residual: torch.Tensor
    residuals: torch.Tensor | None = None
    cg_mvms: int | None = None   # MVMs the mBCG loop ran (PCGResult.loop_mvms)


def operator_mll_forward(op, y, generator: torch.Generator | None = None, *,
                         precond_rank: int, num_probes: int,
                         max_cg_iters: int, min_cg_iters: int, cg_tol: float,
                         pcg_method: str = "standard", precond=None,
                         probes: torch.Tensor | None = None,
                         x0: torch.Tensor | None = None,
                         logdet_carry: torch.Tensor | None = None,
                         track_residuals: bool = False):
    """Paper Eq. 1 against a KernelOperator, single-device or sharded (y is
    the operator-local slice of the targets; scalar reductions go through
    `op.allreduce`).

    y and every SLQ probe ride the SAME (n, t+1) mBCG block. Warm-start
    surface (`repro_torch.train.solver_state`): `precond` reuses a
    preconditioner, `probes` a probe block (P-distributed draws of that
    same preconditioner; otherwise drawn from `generator`), `x0` seeds the
    solve, and `logdet_carry` replaces the SLQ estimate (warm probe
    iterates do not estimate it).

    Returns ((value, aux), (yc, u_y, U, pinv_z), state): the saved solves
    the backward contracts, and the `SolveState` (solutions + probes) for
    the next step. The single-device engine calls the three pieces
    (`operator_mll_solve`, `operator_mll_logdet`, `operator_mll_value`)
    itself, so that under tracing it can time each one.
    """
    if precond is None:
        precond = op.preconditioner(precond_rank)
    solved = operator_mll_solve(
        op, y, generator, precond=precond, num_probes=num_probes,
        max_cg_iters=max_cg_iters, min_cg_iters=min_cg_iters, cg_tol=cg_tol,
        pcg_method=pcg_method, probes=probes, x0=x0,
        track_residuals=track_residuals)
    res = solved[2]
    logdet = operator_mll_logdet(precond, res) if logdet_carry is None \
        else logdet_carry
    return operator_mll_value(op.shape[0], solved, logdet)


def operator_mll_solve(op, y, generator, *, precond, num_probes: int,
                       max_cg_iters: int, min_cg_iters: int, cg_tol: float,
                       pcg_method: str = "standard", probes=None, x0=None,
                       track_residuals: bool = False):
    """The mBCG half of the forward: (yc, probes, PCGResult, pinv_z, quad)."""
    yc = y - constant_mean(op.params)
    if op.local_mask is not None:
        # padded sharded layouts: zero the pad rows of the targets so every
        # CG vector stays in the true-row subspace (n is the TRUE count)
        yc = yc * op.local_mask
    if probes is None:
        probes = precond.sample(generator, num_probes, dtype=yc.dtype)
    B = torch.cat([yc[:, None], probes.to(yc.dtype)], dim=1)
    res = pcg(op, B, precond.solve, max_iters=max_cg_iters,
              min_iters=min_cg_iters, tol=cg_tol, method=pcg_method, x0=x0,
              track_residuals=track_residuals)
    pinv_z = precond.solve(probes)
    quad = op.allreduce(torch.dot(yc, res.solution[:, 0]))
    return yc, probes, res, pinv_z, quad


def operator_mll_logdet(precond, res) -> torch.Tensor:
    """The SLQ log-determinant from the probe columns' mBCG coefficients."""
    return precond.logdet() + slq_logdet_correction(
        res.alphas[:, 1:], res.betas[:, 1:], res.active[:, 1:], res.rz0[1:])


def operator_mll_value(n: int, solved, logdet):
    """((value, aux), (yc, u_y, U, pinv_z), state) of `operator_mll_forward`
    from `operator_mll_solve`'s output and the log-determinant."""
    yc, probes, res, pinv_z, quad = solved
    value = -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))
    aux = MLLAux(logdet=logdet, quad=quad, cg_iterations=res.iterations,
                 rel_residual=res.rel_residual, residuals=res.residuals,
                 cg_mvms=res.loop_mvms)
    state = res.state._replace(probes=probes)
    return (value, aux), (yc, res.solution[:, 0], res.solution[:, 1:],
                          pinv_z), state


def eq2_route_counter(route: str) -> obs.Counter:
    """The registry's count of Eq. 2 backwards that took `route` ("fused" or
    "autograd", `KernelOperator.routed_quad_form_grads`)."""
    return obs.counter(f"mll.eq2_route.{route}")


def _routed_quad_grads(make_op, X, u_y, U, pinv_z, need_x):
    """`operator_mll_quad_grads`'s (g_params, g_X) and the route the
    operator's contraction took, counted (`eq2_route_counter`)."""
    t = max(U.shape[1], 1)
    op = make_op(X)
    A = torch.cat([-u_y[:, None], U / t], dim=1)
    V = torch.cat([u_y[:, None], pinv_z.to(U.dtype)], dim=1)
    gp, gx, route = op.routed_quad_form_grads(A, V, need_x=need_x)
    eq2_route_counter(route).inc()
    return (params_map(lambda a: -0.5 * a, gp),
            None if gx is None else -0.5 * gx, route)


def operator_mll_quad_grads(make_op, X, u_y, U, pinv_z, need_x: bool = True):
    """Paper Eq. 2 assembly: (g_params, g_X) of the MLL w.r.t. (theta, X),
    before the g_value scaling and the raw_mean term. The data-fit term
    -u_y^T dK u_y and the trace term (1/t) sum_i u_i^T dK P^{-1} z_i are
    linear in the (a, v) column pairs, so they batch into ONE
    `quad_form_grads` call over t+1 columns. With need_x False the
    operator may leave g_X out (None)."""
    return _routed_quad_grads(make_op, X, u_y, U, pinv_z, need_x)[:2]


def routed_mll_backward(cfg: MLLConfig, X, params, u_y, U, pinv_z, g_value,
                        need_x: bool = True):
    """`operator_mll_backward`'s (g_X, g_y, g_params) and the route its Eq. 2
    contraction took ("fused" or "autograd")."""
    bwd_cfg = cfg.operator_config()._replace(
        compute_dtype=None, backend=backward_backend_for(cfg.backend))
    g_params, g_X, route = _routed_quad_grads(
        lambda x: make_operator(bwd_cfg, x, params, device=x.device),
        X, u_y, U, pinv_z, need_x)
    # mean parameter: d mll / d mu = sum(u_y)
    g_params = g_params._replace(raw_mean=g_params.raw_mean + torch.sum(u_y))
    g_params = params_map(lambda a: g_value * a, g_params)
    return ((None if g_X is None else g_value * g_X), g_value * (-u_y),
            g_params, route)


def operator_mll_backward(cfg: MLLConfig, X, params, u_y, U, pinv_z, g_value,
                          need_x: bool = True):
    """(g_X, g_y, g_params) of g_value * mll from the saved forward solves.

    The backward contracts in full precision through the backend that
    `backward_backend_for` names (dense and partitioned share the blockwise
    autograd partials; pallas takes its fused kernel where it can,
    blocksparse keeps its own). need_x False says the caller drops g_X,
    which may then come back None (fixed-input training needs none)."""
    return routed_mll_backward(cfg, X, params, u_y, U, pinv_z, g_value,
                               need_x)[:3]


class _ExactMLL(torch.autograd.Function):
    """value = mll(X, y, params) with the Eq. 2 backward; the params tree
    travels as its leaves (autograd tracks flat tensor arguments)."""

    @staticmethod
    def forward(ctx, cfg, generator, template, X, y, *leaves):
        params = params_unflatten(template, [a.detach() for a in leaves])
        X, y = X.detach(), y.detach()
        op = make_operator(cfg.operator_config(), X, params, device=X.device)
        (value, aux), (_, u_y, U, pinv_z), _ = operator_mll_forward(
            op, y, generator, precond_rank=cfg.precond_rank,
            num_probes=cfg.num_probes, max_cg_iters=cfg.max_cg_iters,
            min_cg_iters=cfg.min_cg_iters, cg_tol=cfg.cg_tol,
            pcg_method=cfg.pcg_method)
        ctx.cfg = cfg
        ctx.params = params
        ctx.save_for_backward(X, u_y, U, pinv_z)
        aux_t = (aux.logdet, aux.quad, aux.cg_iterations, aux.rel_residual)
        ctx.mark_non_differentiable(*aux_t)
        return (value,) + aux_t

    @staticmethod
    def backward(ctx, g_value, *_):
        X, u_y, U, pinv_z = ctx.saved_tensors
        g_X, g_y, g_params = operator_mll_backward(
            ctx.cfg, X, ctx.params, u_y, U, pinv_z, g_value,
            need_x=ctx.needs_input_grad[3])
        return (None, None, None, g_X, g_y, *params_leaves(g_params))


def _to(a, dev):
    return a.to(dev) if isinstance(a, torch.Tensor) else torch.as_tensor(a, device=dev)


def exact_mll(cfg: MLLConfig, X, y, params, generator=None, *, device=None):
    """Log marginal likelihood (total, not per-datum) and MLLAux on `device`
    (None = the card; raises when there is none). Differentiable w.r.t. X,
    y and every leaf of params through torch autograd (the Eq. 2 backward);
    probes are drawn from `generator` (on that device)."""
    dev = resolve_device(device)
    X, y = _to(X, dev), _to(y, dev)
    params = params_map(lambda a: _to(a, dev), params)
    value, logdet, quad, iters, rel = _ExactMLL.apply(
        cfg, generator, params, X, y, *params_leaves(params))
    return value, MLLAux(logdet=logdet, quad=quad, cg_iterations=iters,
                         rel_residual=rel)


def dense_mll(kernel, X, y, params, noise_floor: float = 1e-4):
    """O(n^3) closed-form MLL by Cholesky — the test oracle."""
    n = X.shape[0]
    yc = y - constant_mean(params)
    L = torch.linalg.cholesky(dense_khat(kernel, X, params, noise_floor))
    alpha = torch.cholesky_solve(yc[:, None], L)[:, 0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    return -0.5 * (torch.dot(yc, alpha) + logdet + n * math.log(2.0 * math.pi))
