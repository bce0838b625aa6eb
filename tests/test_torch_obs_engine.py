"""The instrumented paths of the port, on the CPU (`device="cpu"`).

* The engine's telemetry records carry the reference's keys (mode,
  refreshed, cg_iters, cg_iters_per_rhs, drift, seconds, mvm_launches,
  hbm_bytes_modeled) for the same step on the same inputs, and the
  registry counters the reference's engine records.
* The dispatch under tracing (a fenced span per phase) equals the
  untraced dispatch bit for bit over a cold, warm, refresh, warm schedule.
* The telemetry is registry-backed; the modeled forward traversals are the
  MVMs the solve ran (`PCGResult.loop_mvms` against counted MVMs).
* A traced `fit_exact_gp` has the reference's span set, the untraced loss
  trace, and a phase table that covers its wall within 1%.
* With the health sink on the engine tracks residuals, and a drift past the
  threshold emits `precond.stale`.
* `launch.train --obs-trace` writes a trace with one `mll_step` span per
  step; the sparse plan's counters and the `serve_predict` span.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.core import ExactGP as RefGP
from repro.core import ExactGPConfig as RefGPConfig
from repro.train.solver_state import WarmStartConfig as RefWarm
from repro.train.solver_state import WarmStartEngine as RefEngine
from repro_torch import obs
from repro_torch.core.gp import ExactGP, ExactGPConfig
from repro_torch.core.kernels_math import params_leaves, params_unflatten
from repro_torch.core.pcg import pcg
from repro_torch.interop import params_from_numpy
from repro_torch.obs import health
from repro_torch.obs.report import assign_self_times, load_trace, phase_breakdown
from repro_torch.train.gp_trainer import GPTrainConfig, fit_exact_gp
from repro_torch.train.solver_state import WarmStartConfig, WarmStartEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
GP_KW = dict(kernel="matern32", row_block=32, precond_rank=10, num_probes=4,
             train_max_cg_iters=20)


@pytest.fixture(autouse=True)
def _clean():
    for o in (obs, ref_obs):
        o.disable_tracing(snapshot_metrics=False)
        o.drain_events()
        o.registry().reset()
        o.health.disable_health()
        o.health.drain_health_events()
    yield
    for o in (obs, ref_obs):
        o.disable_tracing(snapshot_metrics=False)
        o.drain_events()
        o.registry().reset()
        o.health.disable_health()
        o.health.drain_health_events()


def _data(n=96, d=5, seed=0):
    """A conformance-size problem (tests/test_conformance.py SHAPES)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = np.sin(X @ rng.normal(size=d)) + 0.1 * rng.normal(size=n)
    return X, y


def _port_params(gp, d):
    return gp.init_params(d, dtype=torch.float64)


# -- the repaired telemetry records ---------------------------------------------


@pytest.mark.parametrize("backend", ["partitioned", "pallas"])
def test_telemetry_records_have_the_reference_keys(backend):
    """The same three steps (cold, warm, refresh) through both engines on
    the same X, y and params: every record holds the reference's keys and
    modes, one iteration count per RHS, and the registry gets the
    reference's counters."""
    X, y = _data()
    ref_gp = RefGP(RefGPConfig(backend=backend, **GP_KW))
    ref_params = ref_gp.init_params(X.shape[1], dtype=jnp.float64)
    gp = ExactGP(ExactGPConfig(backend=backend, **GP_KW), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    warm = dict(refresh_every=2, drift_threshold=10.0)
    ref_eng = RefEngine(ref_gp.config.mll_config(), RefWarm(**warm))
    eng = WarmStartEngine(gp.config.mll_config(), WarmStartConfig(**warm))
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        ref_eng.step(jnp.asarray(X), jnp.asarray(y), ref_params,
                     jax.random.PRNGKey(i))
        eng.step(Xt, yt, params, gen)
    for rec, ref in zip(eng.telemetry, ref_eng.telemetry):
        assert list(rec) == list(ref)
        assert (rec["mode"], rec["refreshed"]) == (ref["mode"], ref["refreshed"])
        assert len(rec["cg_iters_per_rhs"]) == len(ref["cg_iters_per_rhs"]) == 5
        assert rec["cg_iters"] == sum(rec["cg_iters_per_rhs"])
        assert {k: type(v) for k, v in rec.items()} == \
            {k: type(v) for k, v in ref.items()}
    assert [t["mode"] for t in eng.telemetry] == ["cold", "warm", "refresh"]
    solver = ("solver.", "cg.", "mvm.")
    port_snap, ref_snap = obs.registry().snapshot(), ref_obs.registry().snapshot()
    assert {k for k in port_snap if k.startswith(solver)} == \
        {k for k in ref_snap if k.startswith(solver)} == {
            "solver.steps.cold", "solver.steps.warm", "solver.steps.refresh",
            "solver.step_seconds", "cg.iters", "cg.iters_per_rhs",
            "mvm.matmat_launches", "mvm.hbm_bytes_modeled"}


def test_telemetry_is_registry_backed():
    X, y = _data()
    gp = ExactGP(ExactGPConfig(backend="partitioned", **GP_KW), device="cpu")
    cfg = gp.config.mll_config()
    eng = WarmStartEngine(cfg, WarmStartConfig(refresh_every=3))
    params = _port_params(gp, X.shape[1])
    for i in range(3):
        _, aux, _ = eng.step(torch.as_tensor(X), torch.as_tensor(y), params,
                             torch.Generator().manual_seed(i))
        t = eng.telemetry[-1]
        assert t["cg_iters_per_rhs"] == aux.cg_iterations.tolist()
        assert t["cg_iters"] == sum(t["cg_iters_per_rhs"])
        assert t["mvm_launches"] > 0 and t["hbm_bytes_modeled"] > 0
        assert "measured_phase_ms" not in t  # tracing off: no phase spans
    snap = obs.registry().snapshot()
    assert snap["solver.steps.cold"] == 1 and snap["solver.steps.warm"] == 2
    assert snap["cg.iters"] == sum(t["cg_iters"] for t in eng.telemetry)
    assert snap["cg.iters_per_rhs"]["count"] == 3 * (cfg.num_probes + 1)
    assert snap["mvm.matmat_launches"] == sum(t["mvm_launches"]
                                              for t in eng.telemetry)


@pytest.mark.parametrize("method", ["standard", "pipelined"])
@pytest.mark.parametrize("tol,x0", [(1.0, False), (1e-3, True), (1e-9, False)])
def test_pcg_reports_the_mvms_its_loop_ran(method, tol, x0):
    """The cost model's forward traversals: the MVMs the loop really ran
    (it stops at the check after the last column converged), counted."""
    X, y = _data(n=64, d=2)
    gp = ExactGP(ExactGPConfig(backend="pallas", **GP_KW), device="cpu")
    op = gp.operator(torch.as_tensor(X), _port_params(gp, 2))
    calls = []
    mvm = op.fused_matvec_dots

    def counted(V, R):
        calls.append(1)
        return mvm(V, R)

    op.fused_matvec_dots = counted
    B = torch.as_tensor(np.stack([y, np.cos(X[:, 0]), X[:, 1]], 1))
    guess = 0.5 * B if x0 else None
    res = pcg(op, B, max_iters=40, min_iters=3, tol=tol, method=method,
              x0=guess)
    assert res.loop_mvms == len(calls)


# -- the phase spans ----------------------------------------------------------


@pytest.mark.parametrize("backend", ["partitioned", "pallas"])
def test_traced_dispatch_equals_untraced_bit_for_bit(backend):
    X, y = _data()
    gp = ExactGP(ExactGPConfig(backend=backend, **GP_KW), device="cpu")
    cfg = gp.config.mll_config()
    warm = WarmStartConfig(refresh_every=2, drift_threshold=10.0)

    def run(traced):
        eng = WarmStartEngine(cfg, warm)
        params = _port_params(gp, X.shape[1])
        gen = torch.Generator().manual_seed(0)
        out = []
        if traced:
            obs.enable_tracing(None)
        try:
            for _ in range(4):
                loss, aux, g = eng.step(torch.as_tensor(X), torch.as_tensor(y),
                                        params, gen)
                out.append((loss, aux.logdet, aux.quad, aux.cg_iterations,
                            aux.rel_residual, *params_leaves(g)))
                params = params_unflatten(params, [
                    p - 0.05 * gg for p, gg in zip(params_leaves(params),
                                                   params_leaves(g))])
        finally:
            if traced:
                obs.disable_tracing(snapshot_metrics=False)
        return out, eng.telemetry, obs.drain_events()

    plain, tel0, _ = run(False)
    traced, tel1, events = run(True)
    assert [t["mode"] for t in tel0] == [t["mode"] for t in tel1] == \
        ["cold", "warm", "refresh", "warm"]
    for a, b in zip(plain, traced):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert all("measured_phase_ms" in t for t in tel1)
    phases = [e for e in events if e.get("name") in
              ("precond_build", "cg_solve", "slq_logdet", "eq2_backward")]
    assert len(phases) == 16
    for e in phases:
        assert {"measured_ms", "backend", "modeled_hbm_bytes",
                "modeled_launches"} <= set(e["args"])
        assert e["args"]["backend"] == backend


# -- the traced trainer -------------------------------------------------------


def test_traced_fit_spans_loss_and_wall_coverage():
    X, y = _data(n=64, d=2)
    gp = ExactGP(ExactGPConfig(backend="pallas", **GP_KW))
    cfg = GPTrainConfig(plain_adam_steps=3, refresh_every=2, seed=0)
    res0 = fit_exact_gp(gp, X, y, cfg=cfg, method="adam", device="cpu")
    obs.enable_tracing(None)
    res1 = fit_exact_gp(gp, X, y, cfg=cfg, method="adam", device="cpu")
    obs.disable_tracing(snapshot_metrics=False)
    events = obs.drain_events()
    assert [t["mode"] for t in res0.telemetry] == \
        [t["mode"] for t in res1.telemetry] == ["cold", "warm", "refresh"]
    assert res0.loss_trace == res1.loss_trace
    names = {e["name"] for e in events if e.get("ph") == "X"}
    assert {"fit_exact_gp", "sparse_plan", "mll_step", "optimizer_step",
            "precond_build", "cg_solve", "slq_logdet", "eq2_backward"} <= names
    spans = assign_self_times([e for e in events if e.get("ph") == "X"])
    rows, wall = phase_breakdown(spans, root="fit_exact_gp")
    covered = sum(r.self_ms for r in rows)
    assert wall > 0 and abs(covered - wall) <= 0.01 * wall


def test_traced_pretrain_fit_has_the_stage_spans(tmp_path):
    X, y = _data(n=64, d=2)
    gp = ExactGP(ExactGPConfig(backend="partitioned", lanczos_rank=16,
                               **GP_KW))
    cfg = GPTrainConfig(pretrain_subset=32, pretrain_lbfgs_steps=2,
                        pretrain_adam_steps=2, finetune_adam_steps=2)
    path = str(tmp_path / "t.jsonl")
    with obs.trace_session(path):
        fit_exact_gp(gp, X, y, cfg=cfg, device="cpu",
                     save_artifact=str(tmp_path / "art"))
    events, snap = load_trace(path)
    names = [e["name"] for e in events]
    for name in ("fit_exact_gp", "pretrain_lbfgs", "pretrain_adam",
                 "sparse_plan", "optimizer_step", "save_artifact"):
        assert name in names
    assert names.count("mll_step") == 2
    assert snap["solver.steps.cold"] == 1


# -- health -------------------------------------------------------------------


def test_health_on_tracks_residuals_and_flags_staleness():
    X, y = _data()
    gp = ExactGP(ExactGPConfig(backend="partitioned", **GP_KW), device="cpu")
    cfg = gp.config.mll_config()
    params = _port_params(gp, X.shape[1])
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    warm = WarmStartConfig(refresh_every=5, drift_threshold=0.1)

    eng0 = WarmStartEngine(cfg, warm)
    assert eng0.track_residuals is False
    loss0, aux0, _ = eng0.step(Xt, yt, params, torch.Generator().manual_seed(0))
    assert aux0.residuals is None

    health.enable_health(None)
    eng1 = WarmStartEngine(cfg, warm)
    assert eng1.track_residuals is True
    loss1, aux1, _ = eng1.step(Xt, yt, params, torch.Generator().manual_seed(0))
    assert aux1.residuals is not None
    assert aux1.residuals.shape == (cfg.max_cg_iters, cfg.num_probes + 1)
    assert torch.equal(loss1, loss0)  # tracking does not perturb the solve
    traj = aux1.residuals.numpy()
    it0 = int(aux1.cg_iterations[0])
    assert traj[it0 - 1, 0] <= traj[0, 0]
    # a hyperparameter move far past the drift threshold: a stale
    # preconditioner, refreshed on this step
    moved = params._replace(raw_lengthscale=params.raw_lengthscale + 1.0)
    eng1.step(Xt, yt, moved, torch.Generator().manual_seed(1))
    kinds = [e["kind"] for e in health.drain_health_events()]
    assert kinds == ["precond.refresh", "precond.stale", "precond.refresh"]
    assert eng1.telemetry[-1]["mode"] == "refresh"
    assert obs.registry().snapshot()["health.precond.stale"] == 1


# -- the launcher, the sparse plan and the serving engine -----------------------


def test_launch_train_obs_trace_writes_mll_step_spans(tmp_path):
    path = tmp_path / "dist.jsonl"
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", ""),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gp-exact-1m", "--gp-n", "512", "--steps", "2", "--device", "cpu",
         "--obs-trace", str(path)],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    events, snap = load_trace(str(path))
    steps = [e for e in events if e.get("name") == "mll_step"]
    assert [e["args"]["mode"] for e in steps] == ["cold", "warm"]
    assert snap["solver.steps.cold"] == 1 and snap["solver.steps.warm"] == 1
    rep = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.obs_report", str(path)],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert rep.returncode == 0 and "| mll_step |" in rep.stdout


def test_sparse_plan_counters_and_serve_predict_span():
    from repro_torch.core.kernels_math import init_kernel_params
    from repro_torch.core.operators import OperatorConfig, make_operator
    from repro_torch.serve import PredictionEngine, fit_posterior
    from repro_torch.sparse import build_plan

    rng = np.random.default_rng(0)
    X = rng.uniform(size=(96, 2))
    kernel = "matern32 * wendland2"
    params = init_kernel_params(kernel, lengthscale=0.2, radius=0.3,
                                noise=0.1, dtype=torch.float64)
    obs.enable_tracing(None)
    plan = build_plan(kernel, X, params, tile=16)
    snap = obs.registry().snapshot()
    assert snap["sparse.plans_built"] == 1
    assert snap["sparse.fill"] == plan.fill
    assert snap["sparse.active_pairs"] == plan.num_pairs
    op = make_operator(OperatorConfig(kernel=kernel, backend="blocksparse",
                                      plan=plan), X, params, device="cpu")
    art = fit_posterior(op, np.sin(4 * X[:, 0]), precond_rank=8,
                        lanczos_rank=8)
    engine = PredictionEngine(art, device="cpu", chunk_size=32)
    engine.predict(X[:40])
    obs.disable_tracing(snapshot_metrics=False)
    events = obs.drain_events()
    marks = [e for e in events if e.get("name") == "sparse_plan"]
    assert marks[0]["ph"] == "i" and marks[0]["args"]["pairs"] == plan.num_pairs
    assert [e["name"] for e in events if e.get("ph") == "X"][-1] == \
        "serve_predict"
    snap = obs.registry().snapshot()
    assert snap["serve.predict_rows"]["count"] == 1
    assert snap["serve.predict_rows"]["max"] == 40
    assert snap["serve.predict_ms"]["count"] == 1
