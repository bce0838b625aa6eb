"""Warm-started training engine: solver state amortized across optimizer steps.

The counterpart of `repro.train.solver_state`. Successive
optimizer steps solve nearly identical systems, so the engine carries:

  * the previous step's converged solutions, which seed mBCG (`x0`);
  * the SLQ probe block, drawn once per refresh and reused, so the probe
    solutions stay valid initial guesses;
  * the preconditioner, reused until the `refresh_every` schedule or the
    relative hyperparameter drift (`param_drift`) forces a rebuild.

CG is exact under any fixed SPD preconditioner and any x0, and the Eq. 2
gradient contracts converged solves, so warm steps change iteration counts,
not the estimator. Warm probe iterates do not re-estimate the SLQ
log-determinant, so warm steps carry the estimate of the last refresh (the
reported loss value is O(drift)-stale between refreshes; the gradients are
current).

Two engines share the schedule and the telemetry (`_WarmEngineBase`):
`WarmStartEngine` on one device and `DistWarmStartEngine` over the sharded
operator of `repro_torch.core.distributed`, run on every rank in step.
"""

from __future__ import annotations

import time
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.mll import (
    MLLAux,
    MLLConfig,
    operator_mll_backward,
    operator_mll_forward,
)
from repro_torch.core.operators import make_operator
from repro_torch.core.pcg import SolveState
from repro_torch.core.pivchol import extend_preconditioner


class WarmStartConfig(NamedTuple):
    """Refresh schedule of the stateful solve engine (the reference's).

    enabled:         False = every step is cold.
    refresh_every:   rebuild the preconditioner + redraw the probes every k
                     steps.
    drift_threshold: max relative change of the constrained hyperparameters
                     since the last refresh before a refresh is forced.
    warm_min_iters:  min CG iterations on warm steps.
    """

    enabled: bool = True
    refresh_every: int = 5
    drift_threshold: float = 0.1
    warm_min_iters: int = 1


class SolverState(NamedTuple):
    """Engine state threaded between steps."""

    solve: SolveState     # solutions (n, 1+t) + probes (n, t)
    precond: Any          # Preconditioner (reused until refresh)
    logdet: torch.Tensor  # SLQ logdet at the last refresh


def _leaf_paths(params, prefix=""):
    """(field path, leaf) pairs of a params NamedTuple tree, in order."""
    if isinstance(params, tuple):
        names = getattr(params, "_fields", None) or range(len(params))
        for name, p in zip(names, params):
            yield from _leaf_paths(p, f"{prefix}.{name}")
    else:
        yield prefix, params


def _softplus_np(x):
    x = np.asarray(x, np.float64)
    return np.log1p(np.exp(-np.abs(x))) + np.maximum(x, 0.0)


def _constrained_leaves(params) -> list:
    """Host-side softplus of every raw leaf that shapes K_hat (all but the
    constant mean), in float64."""
    out = []
    for path, leaf in _leaf_paths(params):
        if path.endswith("raw_mean"):
            continue
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        out.append(_softplus_np(leaf))
    return out


def param_drift(ref, params) -> float:
    """Max relative change of the constrained hyperparameters (the mean
    excluded) between two params trees — the reference's measure."""
    drift = 0.0
    for a, b in zip(_constrained_leaves(ref), _constrained_leaves(params)):
        denom = np.maximum(np.abs(a), 1e-8)
        drift = max(drift, float(np.max(np.abs(b - a) / denom)))
    return drift


class _WarmEngineBase:
    """The refresh schedule, state bookkeeping and per-step telemetry shared
    by both engines. Subclasses provide `_dispatch(mode, X, y, params,
    generator, probes)` returning (loss, MLLAux, g_params, new_state).

    step() returns (loss, aux, g_params) with loss = -mll/n and appends a
    telemetry record (mode "cold" | "refresh" | "warm", refreshed, cg_iters,
    iters_per_rhs, drift, seconds) to `telemetry`. A disabled engine runs
    every step cold.
    """

    def __init__(self, warm: WarmStartConfig | None = None):
        self.warm = warm or WarmStartConfig()
        self.state = None
        self.telemetry: list[dict] = []
        self._params_ref = None
        self._steps_since_refresh = 0

    def _dispatch(self, mode, X, y, params, generator, probes):
        raise NotImplementedError

    def _mode(self, params) -> tuple[str, float]:
        if self.state is None or not self.warm.enabled:
            return "cold", 0.0
        drift = param_drift(self._params_ref, params)
        if drift > self.warm.drift_threshold:
            return "refresh", drift
        if self._steps_since_refresh >= self.warm.refresh_every:
            return "refresh", drift
        return "warm", drift

    def step(self, X, y, params, generator: torch.Generator | None = None, *,
             probes: torch.Tensor | None = None):
        """One MLL evaluation: (loss, MLLAux, g_params). `probes` injects
        the probe block of a cold or refresh step (else it is drawn from
        `generator`); warm steps reuse the carried block."""
        t0 = time.perf_counter()
        mode, drift = self._mode(params)
        loss, aux, g_params, state = self._dispatch(
            mode, X, y, params, generator, None if mode == "warm" else probes)
        iters = aux.cg_iterations.cpu().numpy()
        if self.warm.enabled:
            self.state = state
            if mode != "warm":
                self._params_ref = params
                self._steps_since_refresh = 0
            self._steps_since_refresh += 1
        self.telemetry.append({
            "mode": mode, "refreshed": mode != "warm",
            "cg_iters": int(iters.sum()), "iters_per_rhs": iters.tolist(),
            "drift": float(drift), "seconds": time.perf_counter() - t0})
        return loss, aux, g_params

    def extend_rows(self, m: int) -> None:
        """Absorb m appended training rows into the carried state (streaming
        observations between optimizer steps; the training-side twin of
        `predcache.update_prediction_cache`).

        The solutions are zero-padded (`SolveState.pad_rows`) so the y
        column still warm-starts the (n + m)-row system, and the
        preconditioner factor is zero-row-extended
        (`pivchol.extend_preconditioner`). The probes are not carried, so
        the next step runs as a refresh: fresh probes, and a preconditioner
        whose pivots can land on the new rows.
        """
        if m < 0:
            raise ValueError(f"cannot extend solver state by {m} rows")
        if self.state is None or m == 0:
            return
        self.state = self.state._replace(
            solve=self.state.solve.pad_rows(m),
            precond=extend_preconditioner(self.state.precond, m))
        self._steps_since_refresh = self.warm.refresh_every

    def reset(self):
        self.state = None
        self._params_ref = None
        self._steps_since_refresh = 0


class WarmStartEngine(_WarmEngineBase):
    """Stateful MLL value + gradient engine on one device; the gradients are
    assembled by `operator_mll_backward`."""

    def __init__(self, cfg: MLLConfig, warm: WarmStartConfig | None = None):
        super().__init__(warm)
        self.cfg = cfg

    def _dispatch(self, mode, X, y, params, generator, probes):
        cfg = self.cfg
        op = make_operator(cfg.operator_config(), X, params, device=X.device)
        n = X.shape[0]
        state = self.state
        if mode == "warm":
            precond = op.preconditioner(cfg.precond_rank, reuse=state.precond)
            probes, x0 = state.solve.probes, state.solve.solutions
            logdet_carry = state.logdet
            min_iters = self.warm.warm_min_iters
        else:
            precond = op.preconditioner(cfg.precond_rank)
            logdet_carry = None
            min_iters = cfg.min_cg_iters
            if mode == "refresh":
                # fresh probes invalidate the probe solutions; the y column
                # still warm-starts
                x0 = torch.cat([state.solve.solutions[:, :1],
                                torch.zeros((n, cfg.num_probes), dtype=y.dtype,
                                            device=y.device)], dim=1)
            else:
                x0 = None
        (value, aux), (_, u_y, U, pinv_z), solve = operator_mll_forward(
            op, y, generator, precond_rank=cfg.precond_rank,
            num_probes=cfg.num_probes, max_cg_iters=cfg.max_cg_iters,
            min_cg_iters=min_iters, cg_tol=cfg.cg_tol,
            pcg_method=cfg.pcg_method, precond=precond, probes=probes, x0=x0,
            logdet_carry=logdet_carry)
        _, _, g_params = operator_mll_backward(
            cfg, X, op.params, u_y, U, pinv_z, -1.0 / n)
        new_state = SolverState(solve=solve, precond=precond,
                                logdet=aux.logdet)
        return -value / n, aux, g_params, new_state


class DistWarmStartEngine(_WarmEngineBase):
    """The same engine over the sharded backend, run on every rank in step.

    Wraps `repro_torch.core.distributed.make_warm_mll_step`; X is the full
    padded array and y this rank's chunk (`replicate` / `shard_vector`),
    `probes` this rank's probe chunk; the state is a `DistSolveState`, and
    the (logdet, quad, cg_iterations, rel_residual) aux of the distributed
    MLL is repacked into MLLAux.
    """

    def __init__(self, mesh, geom, cfg, warm: WarmStartConfig | None = None):
        from repro_torch.core.distributed import make_warm_mll_step, replicate

        super().__init__(warm)
        self.mesh = mesh
        self.geom = geom
        self.cfg = cfg
        self._replicate = replicate
        self._fns = make_warm_mll_step(
            mesh, geom, cfg, warm_min_iters=self.warm.warm_min_iters)

    def _dispatch(self, mode, X, y, params, generator, probes):
        params_r = self._replicate(self.mesh, params)
        if mode == "cold":
            out = self._fns.cold(X, y, params_r, generator, probes)
        elif mode == "refresh":
            out = self._fns.refresh(X, y, params_r, generator, self.state,
                                    probes)
        else:
            out = self._fns.warm(X, y, params_r, generator, self.state)
        loss, aux_t, g_params, state = out
        aux = MLLAux(logdet=aux_t[0], quad=aux_t[1], cg_iterations=aux_t[2],
                     rel_residual=aux_t[3])
        return loss, aux, g_params, state
