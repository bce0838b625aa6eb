"""Batched preconditioned conjugate gradients (mBCG).

The counterpart of `repro.core.pcg`: one call solves K_hat^{-1} B for all
columns of B at once and records the step/momentum coefficients
(alpha_j, beta_j). Two loop structures:

  * `method="standard"` — textbook PCG, two dependent reductions per
    iteration;
  * `method="pipelined"` — Chronopoulos–Gear CG: the same iterates, with
    every reduction formable beside the MVM.

Per-column convergence masking is the reference's: an iteration is applied
to a column while its relative residual is above `tol` or `j < min_iters`,
and a masked column's state stays frozen. PyTorch runs the loop eagerly, so
the loop stops once every column is masked (and `j >= min_iters`): from
there on the reference's remaining iterations change nothing. That check
costs a host sync, so it runs every `_CHECK_EVERY` iterations only.
`alphas`/`betas`/`active` (and, with `track_residuals=True`, the
per-iteration relative residuals) are padded to `max_iters` so results line
up with the reference's.

Operators that report `supports_fused_step` (the fused-kernel backend)
supply `fused_matvec_dots`: the MVM and the iteration's reductions from ONE
kernel launch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

_CHECK_EVERY = 8


class SolveState(NamedTuple):
    """Warm-start state: the converged solution block of the last call (the
    natural `x0` for the next call against a nearby K_hat) and, filled in
    by the MLL forward, the SLQ probe block that is reused with it."""

    solutions: torch.Tensor                 # (n, t)
    probes: torch.Tensor | None = None      # (n, t - 1) reused SLQ probes

    def pad_rows(self, m: int) -> "SolveState":
        """The state zero-padded to m appended rows (streaming observations).

        The padded solutions stay valid x0 guesses for the grown system (CG
        is exact from any start; zero is the cold start of the new rows).
        The probes are dropped: a zero-padded draw is not a sample of the
        extended P, so the caller's next step must be a refresh
        (`repro_torch.train.solver_state._WarmEngineBase.extend_rows`).
        """
        if m < 0:
            raise ValueError(f"cannot pad SolveState by {m} rows")
        if m == 0:
            return self
        pad = torch.zeros((m, self.solutions.shape[1]),
                          dtype=self.solutions.dtype,
                          device=self.solutions.device)
        return SolveState(solutions=torch.cat([self.solutions, pad], dim=0),
                          probes=None)


class PCGResult(NamedTuple):
    solution: torch.Tensor     # (n, t)
    alphas: torch.Tensor       # (max_iters, t) step sizes (0 where frozen)
    betas: torch.Tensor        # (max_iters, t) momentum coefficients
    active: torch.Tensor       # (max_iters, t) bool, iteration applied
    rz0: torch.Tensor          # (t,) r0^T P^{-1} r0
    rel_residual: torch.Tensor  # (t,) final ||r|| / ||b||
    iterations: torch.Tensor   # (t,) iterations applied per column
    # (max_iters, t) per-iteration relative residuals with
    # track_residuals=True, else None
    residuals: torch.Tensor | None = None
    # MVMs (kernel-matrix traversals) the loop ran, the warm-init one not
    # included: one per iteration, plus the pipelined method's first
    loop_mvms: int = 0

    @property
    def state(self) -> SolveState:
        return SolveState(solutions=self.solution)


def _identity(x):
    return x


def pcg(
    A,
    B: torch.Tensor,
    precond_solve: Callable | None = None,
    *,
    max_iters: int = 100,
    min_iters: int = 3,
    tol: float = 1.0,
    allreduce: Callable | None = None,
    method: str = "standard",
    x0: torch.Tensor | None = None,
    fused: bool | None = None,
    track_residuals: bool = False,
) -> PCGResult:
    """Solve K_hat U = B for all columns of B at once.

    A: a KernelOperator (its `matvec`, `allreduce` and, where it reports
    `supports_fused_step`, `fused_matvec_dots` are used) or a bare callable
    v -> K_hat v. B: (n, t) or (n,); CG state lives in B.dtype. tol: the
    relative residual threshold ||r||/||b||. x0: an initial guess (one extra
    MVM forms r0 = B - K x0). fused: None = the fused step where supported,
    True = on any operator, False = never. track_residuals: also return the
    relative residual of every iteration (`PCGResult.residuals`).
    """
    fused_mvm = None
    if hasattr(A, "matvec"):
        mvm = A.matvec
        if allreduce is None:
            allreduce = A.allreduce
        if fused is not False and hasattr(A, "fused_matvec_dots"):
            if fused is True or getattr(A, "supports_fused_step", False):
                fused_mvm = A.fused_matvec_dots
    else:
        mvm = A
    if B.ndim == 1:
        res = pcg(A if fused_mvm is not None else mvm, B[:, None], precond_solve,
                  max_iters=max_iters, min_iters=min_iters, tol=tol,
                  allreduce=allreduce, method=method,
                  x0=None if x0 is None else x0[:, None], fused=fused,
                  track_residuals=track_residuals)
        return res._replace(solution=res.solution[:, 0])

    precond_solve = precond_solve or _identity
    allreduce = allreduce or _identity
    if method == "standard":
        loop = _pcg_standard
    elif method == "pipelined":
        loop = _pcg_pipelined
    else:
        raise ValueError(f"unknown PCG method {method!r}")
    res = loop(mvm, B, precond_solve, max_iters, min_iters, tol, allreduce,
               x0, fused_mvm)
    return res if track_residuals else res._replace(residuals=None)


def _safe_div(num, den):
    ok = torch.abs(den) > 1e-30
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def _warm_init(mvm, B, x0):
    """(u0, r0): zero start without an MVM, or r0 = B - K x0."""
    if x0 is None:
        return torch.zeros_like(B), B
    x0 = x0.to(B.dtype)
    return x0, B - mvm(x0)


def _all_frozen(j, min_iters, active) -> bool:
    """Every column masked for good (a host sync, made every few steps)."""
    if j < min_iters or (j + 1) % _CHECK_EVERY:
        return False
    return not bool(active.any())


def _finish(u, r, b_norm2, rz0, ys, max_iters, allreduce, loop_mvms):
    t = u.shape[1]
    alphas = torch.zeros((max_iters, t), dtype=u.dtype, device=u.device)
    betas = torch.zeros_like(alphas)
    actives = torch.zeros((max_iters, t), dtype=torch.bool, device=u.device)
    residuals = torch.zeros_like(alphas)
    if ys:
        k = len(ys)
        alphas[:k] = torch.stack([y[0] for y in ys])
        betas[:k] = torch.stack([y[1] for y in ys])
        actives[:k] = torch.stack([y[2] for y in ys])
        residuals[:k] = torch.stack([y[3] for y in ys])
        # a stopped loop's later iterations would have seen the frozen state
        residuals[k:] = residuals[k - 1]
    rel = torch.sqrt(allreduce(torch.sum(r * r, 0)) / b_norm2)
    return PCGResult(u, alphas, betas, actives, rz0, rel, actives.sum(0),
                     residuals, loop_mvms)


def _pcg_standard(mvm, B, precond_solve, max_iters, min_iters, tol, allreduce,
                  x0=None, fused_mvm=None):
    u, r = _warm_init(mvm, B, x0)
    z = precond_solve(r)
    init = allreduce(torch.stack([torch.sum(r * z, 0), torch.sum(B * B, 0)]))
    rz, b_norm2 = init[0], torch.clamp(init[1], min=1e-30)
    rz0 = rz
    p = z
    ys = []
    for j in range(max_iters):
        if fused_mvm is None:
            Kp = mvm(p)
            red1 = allreduce(torch.stack([torch.sum(p * Kp, 0),
                                          torch.sum(r * r, 0)]))
            pKp, r_norm2 = red1[0], red1[1]
        else:
            # one launch: Kp plus <p, Kp> and <r, r> from the same kernel
            Kp, dots = fused_mvm(p, r)
            red1 = allreduce(dots.to(B.dtype))
            pKp, r_norm2 = red1[0], red1[2]
        rel = torch.sqrt(r_norm2 / b_norm2)
        active = (rel > tol) | (j < min_iters)
        alpha = torch.where(active, _safe_div(rz, pKp), torch.zeros_like(rz))
        u = u + alpha * p
        r = r - alpha * Kp
        z_new = precond_solve(r)
        rz_new = allreduce(torch.sum(r * z_new, 0))
        beta = torch.where(active, _safe_div(rz_new, rz), torch.zeros_like(rz))
        p = torch.where(active, z_new + beta * p, p)
        z = torch.where(active, z_new, z)
        rz = torch.where(active, rz_new, rz)
        ys.append((alpha, beta, active, rel))
        if _all_frozen(j, min_iters, active):
            break
    return _finish(u, r, b_norm2, rz0, ys, max_iters, allreduce, len(ys))


def _pcg_pipelined(mvm, B, precond_solve, max_iters, min_iters, tol, allreduce,
                   x0=None, fused_mvm=None):
    """Chronopoulos–Gear CG: one fused reduction per iteration."""

    def mvm_and_reductions(u_, r_):
        """w = K_hat u plus (gamma, delta, rr) = (<r,u>, <w,u>, <r,r>)."""
        if fused_mvm is None:
            w_ = mvm(u_)
            red = allreduce(torch.stack([torch.sum(r_ * u_, 0),
                                         torch.sum(w_ * u_, 0),
                                         torch.sum(r_ * r_, 0)]))
            return w_, red[0], red[1], red[2]
        w_, dots = fused_mvm(u_, r_)
        red = allreduce(dots.to(B.dtype))
        return w_, red[1], red[0], red[2]

    x, r = _warm_init(mvm, B, x0)
    b_norm2 = torch.clamp(allreduce(torch.sum(B * B, 0)), min=1e-30)
    u = precond_solve(r)
    w, gamma, delta, rr = mvm_and_reductions(u, r)
    rz0 = gamma
    p = torch.zeros_like(B)
    s = torch.zeros_like(B)
    alpha_prev = torch.ones_like(gamma)
    gamma_prev = torch.ones_like(gamma)
    ys = []
    for j in range(max_iters):
        rel = torch.sqrt(rr / b_norm2)
        active = (rel > tol) | (j < min_iters)
        if j == 0:
            beta = torch.zeros_like(gamma)
            denom = delta - beta * gamma
        else:
            beta = _safe_div(gamma, gamma_prev)
            denom = delta - beta * gamma / alpha_prev
        alpha = torch.where(active, _safe_div(gamma, denom), torch.zeros_like(gamma))
        beta = torch.where(active, beta, torch.zeros_like(beta))
        p = torch.where(active, u + beta * p, p)
        s = torch.where(active, w + beta * s, s)
        x = x + alpha * p
        r = r - alpha * s
        u_new = precond_solve(r)
        w_new, gamma_new, delta_new, rr_new = mvm_and_reductions(u_new, r)
        u = torch.where(active, u_new, u)
        w = torch.where(active, w_new, w)
        gamma_prev = torch.where(active, gamma, gamma_prev)
        alpha_prev = torch.where(active, alpha, alpha_prev)
        gamma = torch.where(active, gamma_new, gamma)
        delta = torch.where(active, delta_new, delta)
        rr = torch.where(active, rr_new, rr)
        ys.append((alpha, beta, active, rel))
        if _all_frozen(j, min_iters, active):
            break
    return _finish(x, r, b_norm2, rz0, ys, max_iters, allreduce,
                   len(ys) + 1)


def solve_tolerance_iters(tol: float) -> int:
    """Heuristic iteration cap for a requested tolerance (paper Sec. 3)."""
    if tol >= 1.0:
        return 20
    if tol >= 0.1:
        return 50
    if tol >= 0.01:
        return 100
    return 200
