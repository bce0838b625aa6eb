"""The training slice against the reference, on the same numpy inputs:
SLQ pieces, PCG residual tracking, Adam, L-BFGS, LR schedules and
`param_drift` on fixed inputs, the warm-start engine, and short
`fit_exact_gp` runs (the MLL forward and Eq. 2 backward grid is in
tests/test_torch_mll.py).

Tolerances: SLQ pieces 1e-10 relative (fp64, the same formula); optimizer
steps 1e-6 relative (the same fp32 arithmetic in another order); L-BFGS
1e-4 on the loss trace and 1e-3 on the parameters (ten line searches of
fp32 losses); the fit 0.02 on constrained hyperparameters (stated at the
test: the packages draw different probes).
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ExactGP as RefGP
from repro.core import ExactGPConfig as RefGPConfig
from repro.core import OperatorConfig as RefConfig
from repro.core import init_kernel_params as ref_init_kp
from repro.core import init_params_for as ref_init
from repro.core import make_operator as ref_make
from repro.core import parse_kernel as ref_parse
from repro.core.pcg import pcg as ref_pcg
from repro.core.mll import dense_mll as ref_dense_mll
from repro.core.slq import exact_logdet as ref_exact_logdet
from repro.core.slq import lanczos_tridiag_from_coeffs as ref_tridiag
from repro.core.slq import slq_logdet_correction as ref_slq_corr
from repro.data import synthetic as ref_synthetic
from repro.optim import adam_init as ref_adam_init
from repro.optim import adam_update as ref_adam_update
from repro.optim import lbfgs_minimize as ref_lbfgs
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.train.gp_trainer import GPTrainConfig as RefTrainConfig
from repro.train.gp_trainer import fit_exact_gp as ref_fit
from repro.train.solver_state import param_drift as ref_param_drift
from repro_torch.core.gp import ExactGP, ExactGPConfig, gaussian_nll, rmse
from repro_torch.core.kernels_math import params_leaves, params_unflatten
from repro_torch.core.mll import dense_mll
from repro_torch.core.operators import OperatorConfig, make_operator
from repro_torch.core.pcg import pcg
from repro_torch.core.slq import (
    exact_logdet, lanczos_tridiag_from_coeffs, slq_logdet,
    slq_logdet_correction)
from repro_torch.interop import params_from_numpy
from repro_torch.optim import adam_init, adam_update, lbfgs_minimize
from repro_torch.optim import warmup_cosine
from repro_torch.train.gp_trainer import GPTrainConfig, fit_exact_gp
from repro_torch.train.solver_state import WarmStartEngine, param_drift



def _params(kernel, dtype):
    if "wendland" in kernel:
        p = ref_init_kp(ref_parse(kernel), lengthscale=0.5, radius=1.5,
                        noise=0.3, dtype=jnp.dtype(dtype))
    else:
        p = ref_init(kernel, noise=0.3, dtype=jnp.dtype(dtype))
    return p, params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def _problem(kernel, dtype, n, d, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(dtype)
    y = (np.sin(X.astype(np.float64) @ rng.normal(size=d))
         + 0.1 * rng.normal(size=n)).astype(dtype)
    return X, y, *_params(kernel, dtype)


def _spec(kernel):
    return ref_parse(kernel) if "wendland" in kernel else kernel


def _ops(backend, kernel, X, p_ref, p):
    ref = ref_make(RefConfig(kernel=_spec(kernel), backend=backend,
                             row_block=32), jnp.asarray(X), p_ref)
    port = make_operator(OperatorConfig(kernel=kernel, backend=backend,
                                        row_block=32), X, p, device="cpu")
    return ref, port


# -- SLQ ----------------------------------------------------------------------


def test_lanczos_tridiag_matches_reference():
    rng = np.random.default_rng(0)
    m = 12
    alphas = rng.uniform(0.2, 2.0, m)
    betas = rng.uniform(0.0, 0.8, m)
    active = np.arange(m) < 9
    got = lanczos_tridiag_from_coeffs(torch.as_tensor(alphas),
                                      torch.as_tensor(betas),
                                      torch.as_tensor(active))
    want = ref_tridiag(jnp.asarray(alphas), jnp.asarray(betas),
                       jnp.asarray(active))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_slq_pieces_match_reference():
    """The logdet correction from the same PCG traces, and the dense
    logdet oracle."""
    X, y, p_ref, p = _problem("matern32", "float64", 64, 2)
    ref_op, op = _ops("dense", "matern32", X, p_ref, p)
    Z = np.random.default_rng(1).normal(size=(64, 6))
    pre = ref_op.preconditioner(8)
    res = ref_pcg(ref_op, jnp.asarray(Z), pre.solve, max_iters=40, tol=1e-8)
    got = slq_logdet_correction(*(torch.as_tensor(np.array(a)) for a in
                                  (res.alphas, res.betas, res.active, res.rz0)))
    want = ref_slq_corr(res.alphas, res.betas, res.active, res.rz0)
    assert float(got) == pytest.approx(float(want), rel=1e-10)
    K = np.asarray(ref_op._khat())
    assert float(exact_logdet(torch.as_tensor(K))) == pytest.approx(
        float(ref_exact_logdet(jnp.asarray(K))), rel=1e-12)
    # the standalone estimator with many probes lands near the exact value
    # (500 probes: a few standard errors of this estimator are ~2%)
    est = slq_logdet(op, torch.Generator().manual_seed(0), num_probes=500,
                     precond_rank=8, max_iters=64)
    assert float(est) == pytest.approx(float(exact_logdet(torch.as_tensor(K))),
                                       rel=0.03)


@pytest.mark.parametrize("method", ("standard", "pipelined"))
def test_pcg_track_residuals_matches_reference(method):
    X, y, p_ref, p = _problem("rbf", "float64", 64, 2)
    ref_op, op = _ops("partitioned", "rbf", X, p_ref, p)
    B = np.random.default_rng(2).normal(size=(64, 3))
    res_ref = ref_pcg(ref_op, jnp.asarray(B), max_iters=30, tol=1e-6,
                      method=method, track_residuals=True)
    res = pcg(op, torch.as_tensor(B), max_iters=30, tol=1e-6, method=method,
              track_residuals=True)
    got, want = res.residuals.numpy(), np.asarray(res_ref.residuals)
    np.testing.assert_array_equal(res.active.numpy(), np.asarray(res_ref.active))
    # the trajectories agree while the residual is large; below ~1e-4 the
    # two summation orders drift apart as CG's rounding does
    early = want > 1e-3
    np.testing.assert_allclose(got[early], want[early], rtol=1e-6)
    # a column frozen at convergence keeps its last residual, as in the
    # reference's fixed-trip-count scan
    for c, stop in enumerate(res.iterations.tolist()):
        assert np.all(got[stop:, c] == got[stop, c])
        assert np.all(want[stop:, c] == want[stop, c])
    assert pcg(op, torch.as_tensor(B), max_iters=30).residuals is None


# -- optimizers and drift -------------------------------------------------------


def test_adam_matches_reference():
    _, p = _params("0.5*rbf + matern32", "float32")
    p_ref, _ = _params("0.5*rbf + matern32", "float32")
    rng = np.random.default_rng(0)
    state, state_ref = adam_init(p), ref_adam_init(p_ref)
    for i in range(5):
        g = [rng.normal(size=np.shape(a)).astype(np.float32)
             for a in jax.tree.leaves(p_ref)]
        g_ref = jax.tree.unflatten(jax.tree.structure(p_ref),
                                   [jnp.asarray(a) for a in g])
        lr = warmup_cosine(0.1, 2, 5)
        p, state = adam_update(p, params_unflatten(p, [torch.as_tensor(a)
                                                       for a in g]),
                               state, lr, weight_decay=0.01)
        p_ref, state_ref = ref_adam_update(p_ref, g_ref, state_ref,
                                           ref_warmup_cosine(0.1, 2, 5),
                                           weight_decay=0.01)
    for a, b in zip(params_leaves(p), jax.tree.leaves(p_ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    assert int(state.step) == int(state_ref.step) == 5


def test_lbfgs_matches_reference():
    """Ten L-BFGS steps on the deterministic dense MLL of one problem."""
    X, y, p_ref, p = _problem("matern32", "float32", 64, 2)
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    params, trace = lbfgs_minimize(
        lambda q: -dense_mll("matern32", Xt, yt, q) / 64, p, max_steps=10)
    params_ref, trace_ref = ref_lbfgs(
        lambda q: -ref_dense_mll("matern32", jnp.asarray(X), jnp.asarray(y),
                                 q) / 64, p_ref, max_steps=10)
    assert len(trace) == len(trace_ref)
    np.testing.assert_allclose(trace, trace_ref, rtol=1e-4)
    for a, b in zip(params_leaves(params), jax.tree.leaves(params_ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-3)


def test_param_drift_matches_reference():
    p_ref, p = _params("0.5*rbf + matern32", "float32")
    q_ref = jax.tree.map(lambda a: a * 1.3 + 0.1, p_ref)
    q = params_from_numpy(jax.tree.map(np.asarray, q_ref), "cpu")
    assert param_drift(p, q) == pytest.approx(ref_param_drift(p_ref, q_ref),
                                              rel=1e-12)
    # the mean does not count
    assert param_drift(p, p._replace(raw_mean=p.raw_mean + 5.0)) == 0.0


# -- the engine and the trainer -----------------------------------------------


def test_warm_start_engine_modes_and_gradients():
    """cold -> warm -> refresh on schedule; every step's gradients are the
    Eq. 2 backward of that step's solves."""
    kernel = "matern32 * wendland2"
    X, y, _, p = _problem(kernel, "float64", 96, 2)
    cfg = ExactGPConfig(kernel=kernel, precond_rank=10, train_cg_tol=1e-8,
                        backend="dense").mll_config()
    from repro_torch.train.solver_state import WarmStartConfig

    engine = WarmStartEngine(cfg, WarmStartConfig(refresh_every=2))
    gen = torch.Generator().manual_seed(0)
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    grads = []
    for _ in range(3):
        loss, aux, g = engine.step(Xt, yt, p, gen)
        grads.append(g)
    assert [t["mode"] for t in engine.telemetry] == ["cold", "warm", "refresh"]
    assert engine.telemetry[1]["cg_iters"] < engine.telemetry[0]["cg_iters"]
    # converged solves: the warm step's gradient equals the cold step's
    for a, b in zip(params_leaves(grads[1]), params_leaves(grads[0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)


def test_fit_exact_gp_matches_reference():
    """Five plain-Adam steps on one synthetic draw (built once, handed to
    both): the constrained hyperparameters land within 0.02 of the
    reference's (the two packages draw different probes; 64 probes keep
    the stochastic gradients close)."""
    ds = ref_synthetic.make_regression_dataset("bike", seed=0, max_points=400)
    X = ds.X_train[:192].astype(np.float32)
    y = ds.y_train[:192].astype(np.float32)
    cfg_kw = dict(kernel="matern32", precond_rank=20, num_probes=64,
                  row_block=64)
    res_ref = ref_fit(RefGP(RefGPConfig(**cfg_kw)), jnp.asarray(X),
                      jnp.asarray(y), method="adam",
                      cfg=RefTrainConfig(plain_adam_steps=5))
    res = fit_exact_gp(ExactGP(ExactGPConfig(**cfg_kw)), X, y, method="adam",
                       cfg=GPTrainConfig(plain_adam_steps=5), device="cpu")
    assert len(res.loss_trace) == len(res_ref.loss_trace) == 5
    np.testing.assert_allclose(res.loss_trace, res_ref.loss_trace, rtol=0.02)
    for a, b in zip(params_leaves(res.params), jax.tree.leaves(res_ref.params)):
        sp = lambda x: np.log1p(np.exp(np.asarray(x, np.float64)))  # noqa: E731
        np.testing.assert_allclose(sp(a.numpy()), sp(b), atol=0.02)
    assert [t["mode"] for t in res.telemetry] == \
        [t["mode"] for t in res_ref.telemetry]
    # the trained params go to the reference's classes and back
    assert type(params_from_numpy(jax.tree.map(np.asarray, res_ref.params),
                                  "cpu")).__name__ == "GPParams"


def test_blocksparse_fit_replans_and_serves(tmp_path):
    """A short blocksparse fit from a small radius: the loop replans when
    the drift passes the plan's margin, and saves a servable artifact."""
    rng = np.random.default_rng(0)
    centers = rng.uniform(size=(4, 2))
    X = (centers[rng.integers(0, 4, 160)]
         + 0.05 * rng.normal(size=(160, 2))).astype(np.float32)
    y = np.sin(6 * X[:, 0]).astype(np.float32)
    kernel = "matern32 * wendland2"
    gp = ExactGP(ExactGPConfig(kernel=kernel, precond_rank=10, row_block=32,
                               lanczos_rank=16, backend="blocksparse"))
    from repro_torch.core.kernels_math import init_kernel_params

    p0 = init_kernel_params(kernel, noise=0.3, radius=0.15)
    res = fit_exact_gp(gp, X, y, method="adam", params0=p0, device="cpu",
                       cfg=GPTrainConfig(plain_adam_steps=4, drift_threshold=0.05),
                       save_artifact=str(tmp_path / "art"))
    assert len(res.loss_trace) == 4 and all(np.isfinite(res.loss_trace))
    assert len(res.replans) >= 1
    from repro_torch.serve import PredictionEngine, load_artifact

    art = load_artifact(str(tmp_path / "art"), device="cpu")
    assert art.config.plan is not None and art.meta["solve_rel_residual"] <= 0.01
    mean, var = PredictionEngine(art, device="cpu").predict(X[:20])
    assert float(rmse(mean, torch.as_tensor(y[:20]))) < 0.5
    assert math.isfinite(float(gaussian_nll(mean, var, torch.as_tensor(y[:20]))))
