"""The streaming update against the reference: `extend_preconditioner`,
`SolveState.pad_rows`, `update_prediction_cache` (warm blocked PCG and the
blockwise LOVE extension, on dense, partitioned and pallas), its
compaction, and `WarmStartEngine.extend_rows`.

Both packages start from the same cache (the reference's, handed over as
numpy), so every difference is the update's own. Tolerances are the
conformance ones (values 3e-5 fp32 / 1e-10 fp64, matrices 2e-4 / 1e-9),
relative to each array's largest entry; `mean_iters` is equal in float64
and within one iteration in float32. The mean cache is a CG solution: in
float32 it is held at 2e-3 of its largest entry, as
`tests/test_torch_solvers.py::test_build_prediction_cache_parity` holds a
float32 solve, because CG amplifies summation-order differences.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.pivchol as ref_pivchol
import repro.core.predcache as ref_predcache
from repro.core import OperatorConfig as RefConfig
from repro.core import init_params as ref_init_params
from repro.core import make_operator as ref_make
from repro.core.kernels_math import constant_mean as ref_constant_mean
from repro.core.mll import MLLConfig as RefMLLConfig
from repro.core.pcg import SolveState as RefSolveState
from repro.core.pcg import pcg as ref_pcg
from repro.train.solver_state import WarmStartConfig as RefWarmConfig
from repro.train.solver_state import WarmStartEngine as RefEngine
from repro_torch.core import pivchol, predcache
from repro_torch.core.mll import MLLConfig
from repro_torch.core.operators import OperatorConfig, make_operator
from repro_torch.core.pcg import SolveState
from repro_torch.interop import params_from_numpy
from repro_torch.train.solver_state import WarmStartConfig, WarmStartEngine

VAL_TOL = {"float32": 3e-5, "float64": 1e-10}
MAT_TOL = {"float32": 2e-4, "float64": 1e-9}
SOLVE_TOL = {"float32": 2e-3, "float64": 1e-9}
KW = dict(precond_rank=40, lanczos_rank=200, pred_tol=0.01)


def _stream(n0=160, m=16, k=3, d=3, dtype="float64", seed=0):
    rng = np.random.default_rng(seed)
    n = n0 + k * m
    X = rng.normal(size=(n, d)).astype(dtype)
    y = (np.sin(X.astype(np.float64) @ rng.normal(size=d))
         + 0.1 * rng.normal(size=n)).astype(dtype)
    p_ref = ref_init_params(noise=0.2, dtype=jnp.dtype(dtype))
    return X, y, p_ref, params_from_numpy(jax.tree.map(np.asarray, p_ref), "cpu")


def _ops(backend, X, p_ref, p):
    ref = ref_make(RefConfig(kernel="matern32", backend=backend, row_block=32,
                             interpret=True), jnp.asarray(X), p_ref)
    port = make_operator(OperatorConfig(kernel="matern32", backend=backend,
                                        row_block=32), X, p, device="cpu")
    return ref, port


def _port_cache(c_ref):
    return predcache.PredictionCache(
        *(torch.as_tensor(np.array(a)) for a in c_ref))


def _close(a, b, tol, name):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max(),
                               err_msg=name)


def _check_update(res, res_ref, dtype):
    c, c_ref = res.cache, res_ref.cache
    _close(c.mean_cache.numpy(), c_ref.mean_cache, SOLVE_TOL[dtype], "mean_cache")
    _close(c.var_Q.numpy(), c_ref.var_Q, MAT_TOL[dtype], "var_Q")
    _close(c.var_T_chol.numpy(), c_ref.var_T_chol, MAT_TOL[dtype], "var_T_chol")
    it, it_ref = res.mean_iters.numpy(), np.asarray(res_ref.mean_iters)
    if dtype == "float64":
        _close(c.solve_rel_residual.numpy(), c_ref.solve_rel_residual,
               VAL_TOL[dtype], "solve_rel_residual")
        np.testing.assert_array_equal(it, it_ref)
    else:
        # a residual near the stopping point moves with the CG rounding
        _close(c.solve_rel_residual.numpy(), c_ref.solve_rel_residual,
               SOLVE_TOL[dtype], "solve_rel_residual")
        assert np.abs(it - it_ref).max() <= 1
    assert res.num_new == res_ref.num_new
    assert res.variance_refreshed == res_ref.variance_refreshed


def test_extend_preconditioner_matches_reference():
    X, y, p_ref, p = _stream()
    ref, port = _ops("dense", X, p_ref, p)
    P_ref = ref_pivchol.extend_preconditioner(ref.preconditioner(20), 7)
    P = pivchol.extend_preconditioner(port.preconditioner(20), 7)
    assert P.L.shape == (X.shape[0] + 7, 20)
    np.testing.assert_array_equal(P.L.numpy()[-7:], 0.0)
    _close(P.L.numpy(), P_ref.L, MAT_TOL["float64"], "L")
    _close(P.chol_inner.numpy(), P_ref.chol_inner, MAT_TOL["float64"], "chol")
    B = np.random.default_rng(1).normal(size=(X.shape[0] + 7, 2))
    _close(P.solve(torch.as_tensor(B)).numpy(), P_ref.solve(jnp.asarray(B)),
           MAT_TOL["float64"], "solve")
    assert float(P.logdet()) == pytest.approx(float(P_ref.logdet()), rel=1e-10)
    assert pivchol.extend_preconditioner(P, 0) is P
    with pytest.raises(ValueError):
        pivchol.extend_preconditioner(P, -1)


def test_solve_state_pad_rows_matches_reference():
    rng = np.random.default_rng(2)
    sol, probes = rng.normal(size=(50, 3)), rng.normal(size=(50, 2))
    st = SolveState(torch.as_tensor(sol), torch.as_tensor(probes)).pad_rows(6)
    st_ref = RefSolveState(jnp.asarray(sol), jnp.asarray(probes)).pad_rows(6)
    np.testing.assert_array_equal(st.solutions.numpy(), np.asarray(st_ref.solutions))
    assert st.probes is None and st_ref.probes is None
    same = SolveState(torch.as_tensor(sol))
    assert same.pad_rows(0) is same
    with pytest.raises(ValueError):
        same.pad_rows(-2)


@pytest.mark.parametrize("backend,dtype", (("dense", "float64"),
                                           ("partitioned", "float64"),
                                           ("pallas", "float32")))
def test_update_matches_reference(backend, dtype):
    """One 16-row update from the same cache: the warm blocked solve and
    the blockwise variance extension."""
    n0, m = 160, 16
    X, y, p_ref, p = _stream(n0=n0, m=m, k=1, dtype=dtype)
    ref0, _ = _ops(backend, X[:n0], p_ref, p)
    c_ref = ref_predcache.build_prediction_cache(
        ref0, jnp.asarray(y[:n0]), jax.random.PRNGKey(0), **KW)
    ref, port = _ops(backend, X, p_ref, p)
    res_ref = ref_predcache.update_prediction_cache(
        ref, jnp.asarray(y), c_ref, jax.random.PRNGKey(1), **KW)
    res = predcache.update_prediction_cache(
        port, torch.as_tensor(y), _port_cache(c_ref), **KW)
    _check_update(res, res_ref, dtype)
    assert res.cache.var_Q.shape == (n0 + m, min(200, n0) + m)
    _close(res.precond.L.numpy(), res_ref.precond.L, MAT_TOL[dtype], "precond L")


def test_update_threads_precond_over_batches():
    """Three 16-row batches, each side threading its own extended
    preconditioner: every batch matches the reference's."""
    n0, m, k = 160, 16, 3
    X, y, p_ref, p = _stream(n0=n0, m=m, k=k)
    ref0, _ = _ops("partitioned", X[:n0], p_ref, p)
    c_ref = ref_predcache.build_prediction_cache(
        ref0, jnp.asarray(y[:n0]), jax.random.PRNGKey(0), **KW)
    cache, P, P_ref = _port_cache(c_ref), None, None
    for i in range(k):
        n_i = n0 + (i + 1) * m
        ref, port = _ops("partitioned", X[:n_i], p_ref, p)
        res_ref = ref_predcache.update_prediction_cache(
            ref, jnp.asarray(y[:n_i]), c_ref, jax.random.PRNGKey(i + 1),
            precond=P_ref, **KW)
        res = predcache.update_prediction_cache(
            port, torch.as_tensor(y[:n_i]), cache, precond=P, **KW)
        _check_update(res, res_ref, "float64")
        assert res.precond.L.shape == (n_i, 40)
        c_ref, P_ref = res_ref.cache, res_ref.precond
        cache, P = res.cache, res.precond


def test_update_over_batches_matches_cold_refit():
    """k sequential updates == one cold refit on the full data, for the
    mean and the LOVE variance, within the prediction tolerance (the
    reference's test on the port; Lanczos rank near n, so the comparison
    pins the update algebra)."""
    n0, m, k = 160, 16, 3
    X, y, _, p = _stream(n0=n0, m=m, k=k)
    mk = lambda n: make_operator(  # noqa: E731
        OperatorConfig(kernel="matern32", backend="partitioned", row_block=32),
        X[:n], p, device="cpu")
    gen = torch.Generator().manual_seed(0)
    cache = predcache.build_prediction_cache(mk(n0), torch.as_tensor(y[:n0]),
                                             generator=gen, **KW)
    precond = None
    for i in range(k):
        n_i = n0 + (i + 1) * m
        res = predcache.update_prediction_cache(
            mk(n_i), torch.as_tensor(y[:n_i]), cache, precond=precond, **KW)
        cache, precond = res.cache, res.precond
        assert res.num_new == m
    op = mk(n0 + k * m)
    cold = predcache.build_prediction_cache(op, torch.as_tensor(y),
                                            generator=gen, **KW)
    Xs = torch.as_tensor(np.random.default_rng(5).normal(size=(25, 3)))
    np.testing.assert_allclose(predcache.predict_mean(op, Xs, cache).numpy(),
                               predcache.predict_mean(op, Xs, cold).numpy(),
                               atol=5e-2)
    np.testing.assert_allclose(
        predcache.predict_var_cached(op, Xs, cache).numpy(),
        predcache.predict_var_cached(op, Xs, cold).numpy(), atol=5e-2)
    assert cache.mean_cache.shape == (n0 + k * m,)
    assert cache.var_Q.shape[1] == min(KW["lanczos_rank"], n0) + k * m


def test_update_warm_solve_cheaper_than_cold():
    """Fewer CG iterations than a cold solve of the same extended system at
    the same tolerance, on both packages' counts."""
    n0, m = 160, 16
    X, y, p_ref, p = _stream(n0=n0, m=m, k=1)
    kw = dict(precond_rank=40, lanczos_rank=80, pred_tol=0.01)
    _, port0 = _ops("partitioned", X[:n0], p_ref, p)
    ref, port = _ops("partitioned", X, p_ref, p)
    cache = predcache.build_prediction_cache(
        port0, torch.as_tensor(y[:n0]), generator=torch.Generator().manual_seed(0),
        **kw)
    res = predcache.update_prediction_cache(port, torch.as_tensor(y), cache, **kw)
    warm = int(res.mean_iters.max())
    yc = torch.as_tensor(y) - port.params.raw_mean
    cold = predcache.pcg(port, yc[:, None], port.preconditioner(40).solve,
                         max_iters=400, min_iters=1, tol=0.01)
    yc_ref = jnp.asarray(y) - ref_constant_mean(ref.params)
    cold_ref = ref_pcg(ref, yc_ref[:, None], ref.preconditioner(40).solve,
                       max_iters=400, min_iters=1, tol=0.01)
    assert int(cold.iterations.max()) == int(np.asarray(cold_ref.iterations).max())
    assert warm < int(cold.iterations.max())
    assert float(res.cache.solve_rel_residual.max()) <= 0.01


def test_update_compaction_refreshes_variance():
    """Past max_rank the update re-runs the full Lanczos pass; with the
    reference's start vector (drawn from its key) injected as `v0`, Q and
    chol(T) are the reference's."""
    n0, m = 160, 16
    X, y, p_ref, p = _stream(n0=n0, m=m, k=1)
    kw = dict(precond_rank=40, lanczos_rank=60, max_rank=64, pred_tol=0.01)
    ref0, _ = _ops("partitioned", X[:n0], p_ref, p)
    c_ref = ref_predcache.build_prediction_cache(
        ref0, jnp.asarray(y[:n0]), jax.random.PRNGKey(0), precond_rank=40,
        lanczos_rank=60, pred_tol=0.01)
    ref, port = _ops("partitioned", X, p_ref, p)
    key = jax.random.PRNGKey(1)
    res_ref = ref_predcache.update_prediction_cache(
        ref, jnp.asarray(y), c_ref, key, **kw)
    v0 = np.array(jax.random.normal(key, (n0 + m,), jnp.float64))
    res = predcache.update_prediction_cache(
        port, torch.as_tensor(y), _port_cache(c_ref), v0=torch.as_tensor(v0), **kw)
    assert res.variance_refreshed and res_ref.variance_refreshed
    assert res.cache.var_Q.shape == (n0 + m, 60)
    _check_update(res, res_ref, "float64")


def test_update_rejects_non_grown_operator():
    X, y, p_ref, p = _stream(n0=64, m=0, k=0)
    _, port = _ops("dense", X, p_ref, p)
    cache = predcache.build_prediction_cache(
        port, torch.as_tensor(y), generator=torch.Generator().manual_seed(0),
        precond_rank=20, lanczos_rank=30)
    with pytest.raises(ValueError, match="at least one new row"):
        predcache.update_prediction_cache(port, torch.as_tensor(y), cache)


def test_engine_extend_rows_forces_refresh():
    """A cold step on n rows, `extend_rows(m)`, a step on n + m rows: it
    runs as a refresh (fresh probes, the padded y solution as x0), and with
    the reference's probes injected its loss is the reference's."""
    n0, m, num_probes = 96, 12, 4
    X, y, p_ref, p = _stream(n0=n0, m=m, k=1)
    cfg_kw = dict(kernel="matern32", precond_rank=10, num_probes=num_probes,
                  max_cg_iters=200, cg_tol=1e-8, row_block=32,
                  backend="partitioned")
    ref_engine = RefEngine(RefMLLConfig(**cfg_kw), RefWarmConfig(),
                           track_residuals=False)
    engine = WarmStartEngine(MLLConfig(**cfg_kw), WarmStartConfig())
    losses = []
    for n, seed in ((n0, 0), (n0 + m, 1)):
        key = jax.random.PRNGKey(seed)
        ref_op, _ = _ops("partitioned", X[:n], p_ref, p)
        probes = np.array(ref_op.preconditioner(10).sample(
            key, num_probes, dtype=jnp.float64))
        l_ref, _, _ = ref_engine.step(jnp.asarray(X[:n]), jnp.asarray(y[:n]),
                                      p_ref, key)
        loss, _, _ = engine.step(torch.as_tensor(X[:n]), torch.as_tensor(y[:n]),
                                 p, probes=torch.as_tensor(probes))
        losses.append((float(loss), float(l_ref)))
        if n == n0:
            engine.extend_rows(m)
            ref_engine.extend_rows(m)
            assert engine.state.solve.solutions.shape == (n0 + m, 1 + num_probes)
            assert engine.state.solve.probes is None
            assert engine.state.precond.L.shape == (n0 + m, 10)
    assert [t["mode"] for t in engine.telemetry] == ["cold", "refresh"]
    assert [t["mode"] for t in ref_engine.telemetry] == ["cold", "refresh"]
    for loss, l_ref in losses:
        assert loss == pytest.approx(l_ref, rel=1e-10)
    with pytest.raises(ValueError):
        engine.extend_rows(-1)
