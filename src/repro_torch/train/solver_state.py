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
Each step opens an `mll_step` span and appends the reference's telemetry
record (`obs.record_solver_step`: mode, refreshed, cg_iters,
cg_iters_per_rhs, drift, seconds, and the cost model's mvm_launches and
hbm_bytes_modeled); the health sentinels (`obs.health`) run on its aux.
Under tracing `WarmStartEngine` wraps each of its four pieces,
precond_build, cg_solve, slq_logdet and eq2_backward, in a span closed by a
fence, each span carrying its measured ms and its modeled bytes and
launches; the eq2_backward span also names the route the backward took
("fused" or "autograd", as `routed_mll_backward` reports it).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.mll import (
    MLLConfig,
    operator_mll_logdet,
    operator_mll_solve,
    operator_mll_value,
    routed_mll_backward,
)
from repro_torch.core.operators import make_operator
from repro_torch.core.pcg import SolveState
from repro_torch.core.pivchol import extend_preconditioner
from repro_torch.kernels.kmvm import ROW_TILE
from repro_torch.obs import health as obs_health


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


def _fence(device: torch.device) -> None:
    """Wait for the device's queued work (the phase spans' fence)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


_UNTRACED = contextlib.nullcontext()


class _Phases:
    """The phase spans of one `WarmStartEngine` step. Under tracing each
    phase is a span closed by a fence (`torch.cuda.synchronize` on the
    card) and stamped with its measured ms, the backend and its modeled
    bytes and launches (`obs.mll_phase_costs` at the port's geometry);
    otherwise each phase is a null context. The dispatch sets `res` once
    the solve has run (the later phases' price depends on its MVMs) and
    `route` inside eq2_backward, which its span carries."""

    def __init__(self, engine, mode, X):
        self.traced = obs.tracing_enabled()
        self.engine, self.mode, self.X = engine, mode, X
        self.res = self.route = None
        self.ms: dict[str, float] = {}

    def __call__(self, phase):
        return self._span(phase) if self.traced else _UNTRACED

    @contextlib.contextmanager
    def _span(self, phase):
        with obs.span(phase, mode=self.mode) as sp:
            t = time.perf_counter()
            yield
            _fence(self.X.device)
            ms = self.ms[phase] = (time.perf_counter() - t) * 1e3
            eng, res = self.engine, self.res
            # (the preconditioner's price does not depend on the MVMs)
            cost = obs.mll_phase_costs(
                **eng._cost_args(self.mode, self.X,
                                 0 if res is None else res.loop_mvms),
                precond_rank=(eng.cfg.precond_rank if self.mode != "warm"
                              else 0))[phase]
            sp.set(measured_ms=ms, backend=eng.cfg.backend,
                   modeled_hbm_bytes=cost.hbm_bytes,
                   modeled_launches=cost.launches)
            if phase == "cg_solve":
                sp.set(cg_iters=int(res.iterations.sum()))
            if phase == "eq2_backward":
                sp.set(route=self.route)


class _WarmEngineBase:
    """The refresh schedule, state bookkeeping and per-step telemetry shared
    by both engines. Subclasses provide `_dispatch(mode, X, y, params,
    generator, probes)` returning (loss, MLLAux, g_params, new_state).

    step() returns (loss, aux, g_params) with loss = -mll/n and appends the
    step's `obs.record_solver_step` record to `telemetry`. A disabled
    engine runs every step cold. track_residuals (None = whether the
    health sink is on at construction) asks PCG for the per-iteration
    residuals the stagnation and divergence sentinels read.
    """

    def __init__(self, warm: WarmStartConfig | None = None,
                 track_residuals: bool | None = None):
        self.warm = warm or WarmStartConfig()
        self.state = None
        self.telemetry: list[dict] = []
        self._params_ref = None
        self._steps_since_refresh = 0
        if track_residuals is None:
            track_residuals = obs_health.health_enabled()
        self.track_residuals = bool(track_residuals)
        self._last_phase_ms: dict | None = None

    def _dispatch(self, mode, X, y, params, generator, probes):
        raise NotImplementedError

    def _cost_args(self, mode, X, loop_mvms: int) -> dict:
        """The cost model's arguments for this step: the port's geometry
        (the fused kernels' 64-row tile) and the MVMs the solve's loop ran
        (`PCGResult.loop_mvms`)."""
        cfg = self.cfg
        plan = getattr(cfg, "plan", None)
        return dict(
            n=int(X.shape[0]), d=int(X.shape[-1]),
            num_rhs=1 + int(cfg.num_probes),
            max_cg_iters=int(loop_mvms),
            backend=getattr(cfg, "backend", "partitioned"),
            row_block=int(getattr(cfg, "row_block", 1024)), bm=ROW_TILE,
            fill=float(plan.fill) if plan is not None else 1.0,
            warm_init=mode != "cold")

    def _mode(self, params) -> tuple[str, float]:
        if self.state is None or not self.warm.enabled:
            return "cold", 0.0
        drift = param_drift(self._params_ref, params)
        if drift > self.warm.drift_threshold:
            obs_health.precond_stale(step=len(self.telemetry), drift=drift,
                                     threshold=self.warm.drift_threshold)
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
        probes = None if mode == "warm" else probes
        with obs.span("mll_step", mode=mode, drift=float(drift)) as sp:
            loss, aux, g_params, state = self._dispatch(
                mode, X, y, params, generator, probes)
            iters = aux.cg_iterations.cpu().numpy()
            sp.set(cg_iters=int(iters.sum()))
        cfg = self.cfg
        obs_health.check_solver_step(
            step=len(self.telemetry), mode=mode, tol=float(cfg.cg_tol),
            max_iters=int(cfg.max_cg_iters), iters_per_rhs=iters,
            rel_residual=aux.rel_residual.cpu().numpy(),
            residuals=(None if aux.residuals is None
                       else aux.residuals.cpu().numpy()),
            drift=drift)
        if self.warm.enabled:
            self.state = state
            if mode != "warm":
                self._params_ref = params
                self._steps_since_refresh = 0
            self._steps_since_refresh += 1
        cost = obs.mll_step_cost(**self._cost_args(mode, X, aux.cg_mvms))
        phase_ms, self._last_phase_ms = self._last_phase_ms, None
        self.telemetry.append(obs.record_solver_step(
            mode=mode, iters_per_rhs=iters, drift=float(drift),
            seconds=time.perf_counter() - t0, launches=cost.launches,
            hbm_bytes=cost.hbm_bytes, phase_ms=phase_ms))
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
    assembled by `routed_mll_backward`, which needs no X gradient here
    (the inputs are fixed), so the pallas backend's fused kernel serves
    it."""

    def __init__(self, cfg: MLLConfig, warm: WarmStartConfig | None = None,
                 track_residuals: bool | None = None):
        super().__init__(warm, track_residuals)
        self.cfg = cfg

    def _dispatch(self, mode, X, y, params, generator, probes):
        """The step's pieces in order, each in its phase (`_Phases`):
        operator and preconditioner, the mBCG solve, the SLQ
        log-determinant (warm steps carry the last refresh's), then the
        Eq. 2 backward."""
        cfg, state = self.cfg, self.state
        n = X.shape[0]
        phase = _Phases(self, mode, X)
        with phase("precond_build"):
            op = make_operator(cfg.operator_config(), X, params,
                               device=X.device)
            precond = op.preconditioner(
                cfg.precond_rank,
                reuse=state.precond if mode == "warm" else None)
        with phase("cg_solve"):
            if mode == "warm":
                probes, x0 = state.solve.probes, state.solve.solutions
                logdet_carry = state.logdet
                min_iters = self.warm.warm_min_iters
            else:
                logdet_carry = None
                min_iters = cfg.min_cg_iters
                if mode == "refresh":
                    # fresh probes invalidate the probe solutions; the y
                    # column still warm-starts
                    x0 = torch.cat([state.solve.solutions[:, :1],
                                    torch.zeros((n, cfg.num_probes),
                                                dtype=y.dtype,
                                                device=y.device)], dim=1)
                else:
                    x0 = None
            solved = operator_mll_solve(
                op, y, generator, precond=precond, num_probes=cfg.num_probes,
                max_cg_iters=cfg.max_cg_iters, min_cg_iters=min_iters,
                cg_tol=cfg.cg_tol, pcg_method=cfg.pcg_method, probes=probes,
                x0=x0, track_residuals=self.track_residuals)
            phase.res = solved[2]
        with phase("slq_logdet"):
            logdet = operator_mll_logdet(precond, phase.res) \
                if logdet_carry is None else logdet_carry
        (value, aux), (_, u_y, U, pinv_z), solve = operator_mll_value(
            n, solved, logdet)
        with phase("eq2_backward"):
            _, _, g_params, phase.route = routed_mll_backward(
                cfg, X, op.params, u_y, U, pinv_z, -1.0 / n, need_x=False)
        self._last_phase_ms = phase.ms or None
        new_state = SolverState(solve=solve, precond=precond,
                                logdet=aux.logdet)
        return -value / n, aux, g_params, new_state


class DistWarmStartEngine(_WarmEngineBase):
    """The same engine over the sharded backend, run on every rank in step.

    Wraps `repro_torch.core.distributed.make_warm_mll_step`; X is the full
    padded array and y this rank's chunk (`replicate` / `shard_vector`),
    `probes` this rank's probe chunk; the state is a `DistSolveState`.
    """

    def __init__(self, mesh, geom, cfg, warm: WarmStartConfig | None = None):
        from repro_torch.core.distributed import make_warm_mll_step, replicate

        # the distributed step returns no residual trajectories
        super().__init__(warm, track_residuals=False)
        self.mesh = mesh
        self.geom = geom
        self.cfg = cfg
        self._replicate = replicate
        self._fns = make_warm_mll_step(
            mesh, geom, cfg, warm_min_iters=self.warm.warm_min_iters)

    def _dispatch(self, mode, X, y, params, generator, probes):
        params_r = self._replicate(self.mesh, params)
        if mode == "cold":
            return self._fns.cold(X, y, params_r, generator, probes)
        if mode == "refresh":
            return self._fns.refresh(X, y, params_r, generator, self.state,
                                     probes)
        return self._fns.warm(X, y, params_r, generator, self.state)
