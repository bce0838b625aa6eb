"""The port's solvers against the reference's: pivoted Cholesky and its
preconditioner, PCG (standard, pipelined, and the fused step), Lanczos and
the prediction cache. PCG runs with `min_iters == max_iters`, so iterates
and alpha/beta line up step for step; Lanczos gets the same numpy start
vector on both sides.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OperatorConfig as RefConfig
from repro.core import init_params_for as ref_init
from repro.core import make_operator as ref_make
from repro.core.pcg import pcg as ref_pcg
import repro.core.pivchol as ref_pivchol
import repro.core.predcache as ref_predcache
from repro_torch.core.pcg import pcg
from repro_torch.core import pivchol, predcache
from repro_torch.core.operators import OperatorConfig, make_operator
from repro_torch.interop import params_from_numpy

VAL_TOL = {"float32": 3e-5, "float64": 1e-10}
MAT_TOL = {"float32": 2e-4, "float64": 1e-9}


def _setup(kernel="matern32", dtype="float64", n=96, d=5, backend="dense",
           noise=0.3, seed=0, t=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(dtype)
    B = rng.normal(size=(n, t)).astype(dtype)
    p_ref = ref_init(kernel, noise=noise, dtype=jnp.dtype(dtype))
    p = params_from_numpy(jax.tree.map(np.asarray, p_ref))
    ref = ref_make(RefConfig(kernel=kernel, backend=backend, row_block=32,
                             interpret=True), jnp.asarray(X), p_ref)
    port = make_operator(OperatorConfig(kernel=kernel, backend=backend,
                                        row_block=32), X, p, device="cpu")
    return ref, port, X, B


@pytest.mark.parametrize("kernel", ("matern32", "0.5*rbf + matern32"))
def test_pivoted_cholesky_and_preconditioner_parity(kernel):
    ref, port, X, B = _setup(kernel)
    L_ref = np.asarray(ref_pivchol.pivoted_cholesky(kernel, jnp.asarray(X),
                                                    ref.params, 20))
    L = pivchol.pivoted_cholesky(kernel, port.X, port.params, 20).numpy()
    np.testing.assert_allclose(L, L_ref, rtol=1e-9, atol=1e-9)
    P_ref = ref.preconditioner(20)
    P = port.preconditioner(20)
    np.testing.assert_allclose(P.solve(torch.as_tensor(B)).numpy(),
                               np.asarray(P_ref.solve(jnp.asarray(B))),
                               rtol=1e-9, atol=1e-9)
    assert float(P.logdet()) == pytest.approx(float(P_ref.logdet()), rel=1e-10)
    assert port.preconditioner(20, reuse=P) is P
    P0 = port.preconditioner(0)
    np.testing.assert_allclose(P0.solve(torch.as_tensor(B)).numpy(),
                               np.asarray(ref.preconditioner(0).solve(jnp.asarray(B))))


CASES = [  # (backend, dtype, method, fused)
    ("dense", "float64", "standard", None),
    ("dense", "float64", "pipelined", None),
    ("partitioned", "float64", "standard", True),
    ("pallas", "float32", "standard", None),   # the fused step, by capability
    ("pallas", "float32", "pipelined", None),
    ("pallas", "float32", "standard", False),
]


@pytest.mark.parametrize("backend,dtype,method,fused", CASES)
def test_pcg_step_for_step(backend, dtype, method, fused):
    ref, port, X, B = _setup("0.5*rbf + matern32", dtype, backend=backend)
    P_ref, P = ref.preconditioner(10), port.preconditioner(10)
    iters = 12
    kw = dict(max_iters=iters, min_iters=iters, tol=1e-3, method=method, fused=fused)
    r_ref = ref_pcg(ref, jnp.asarray(B), P_ref.solve, **kw)
    r = pcg(port, torch.as_tensor(B), P.solve, **kw)
    # fp32 CG amplifies summation-order differences step by step
    tol = 1e-8 if dtype == "float64" else 2e-3
    for name in ("solution", "alphas", "betas", "rz0", "rel_residual"):
        np.testing.assert_allclose(getattr(r, name).numpy(),
                                   np.asarray(getattr(r_ref, name)),
                                   rtol=tol, atol=tol, err_msg=name)
    np.testing.assert_array_equal(r.active.numpy(), np.asarray(r_ref.active))
    np.testing.assert_array_equal(r.iterations.numpy(), np.asarray(r_ref.iterations))


@pytest.mark.parametrize("method", ("standard", "pipelined"))
def test_pcg_early_stop_matches_fixed_trip(method):
    """The eager loop stops once every column is masked; the result still
    equals the reference's fixed-trip run, padded to max_iters."""
    ref, port, X, B = _setup("matern32", "float64", noise=0.5, t=3)
    P_ref, P = ref.preconditioner(30), port.preconditioner(30)
    kw = dict(max_iters=60, min_iters=3, tol=1e-6, method=method)
    r_ref = ref_pcg(ref, jnp.asarray(B), P_ref.solve, **kw)
    r = pcg(port, torch.as_tensor(B), P.solve, **kw)
    assert int(np.asarray(r_ref.iterations).max()) < 50  # the early stop fires
    assert r.alphas.shape == (60, 3)
    np.testing.assert_array_equal(r.active.numpy(), np.asarray(r_ref.active))
    np.testing.assert_allclose(r.solution.numpy(), np.asarray(r_ref.solution),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(r.alphas.numpy(), np.asarray(r_ref.alphas),
                               rtol=1e-8, atol=1e-12)


def test_pcg_warm_start_and_vector_rhs():
    ref, port, X, B = _setup("rbf", "float64")
    x0 = 0.1 * B[:, 0]
    kw = dict(max_iters=20, min_iters=20, tol=1e-8)
    r_ref = ref_pcg(ref, jnp.asarray(B[:, 0]), x0=jnp.asarray(x0), **kw)
    r = pcg(port, torch.as_tensor(B[:, 0]), x0=torch.as_tensor(x0), **kw)
    assert r.solution.shape == (96,)
    np.testing.assert_allclose(r.solution.numpy(), np.asarray(r_ref.solution),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(r.state.solutions.numpy(), r.solution.numpy())


@pytest.mark.parametrize("backend,dtype", (("dense", "float64"), ("pallas", "float32")))
def test_lanczos_parity(backend, dtype):
    ref, port, X, _ = _setup("matern32", dtype, backend=backend)
    v0 = np.random.default_rng(3).normal(size=96).astype(dtype)
    Q_ref, T_ref = ref_predcache.lanczos(ref.matvec, jnp.asarray(v0), 16)
    Q, T = predcache.lanczos(port.matvec, torch.as_tensor(v0), 16)
    tol = MAT_TOL[dtype]
    np.testing.assert_allclose(T.numpy(), np.asarray(T_ref), rtol=tol, atol=tol)
    np.testing.assert_allclose(Q.numpy(), np.asarray(Q_ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("backend,dtype", (("partitioned", "float64"),
                                           ("pallas", "float32")))
def test_build_prediction_cache_parity(backend, dtype):
    """Mean cache, Lanczos cache and predictions, with the reference's own
    start vector (drawn from its key) handed to the port."""
    ref, port, X, B = _setup("matern32", dtype, backend=backend, noise=0.1)
    y = np.sin(X.sum(1)).astype(dtype)
    key = jax.random.PRNGKey(0)
    c_ref = ref_predcache.build_prediction_cache(
        ref, jnp.asarray(y), key, precond_rank=20, lanczos_rank=24, pred_tol=1e-6,
        max_cg_iters=200)
    v0 = np.array(jax.random.normal(key, (96,), ref_predcache.solver_dtype(ref)))
    c = predcache.build_prediction_cache(
        port, torch.as_tensor(y), v0=torch.as_tensor(v0), precond_rank=20,
        lanczos_rank=24, pred_tol=1e-6, max_cg_iters=200)
    tol = 1e-7 if dtype == "float64" else 2e-3
    np.testing.assert_allclose(c.mean_cache.numpy(), np.asarray(c_ref.mean_cache),
                               rtol=tol, atol=tol * np.abs(np.asarray(c_ref.mean_cache)).max())
    np.testing.assert_allclose(c.var_T_chol.numpy(), np.asarray(c_ref.var_T_chol),
                               rtol=MAT_TOL[dtype], atol=MAT_TOL[dtype])
    Z = np.random.default_rng(4).normal(size=(30, 5)).astype(dtype)
    m_ref = np.asarray(ref_predcache.predict_mean(ref, jnp.asarray(Z), c_ref))
    v_ref = np.asarray(ref_predcache.predict_var_cached(ref, jnp.asarray(Z), c_ref))
    m = predcache.predict_mean(port, torch.as_tensor(Z), c).numpy()
    v = predcache.predict_var_cached(port, torch.as_tensor(Z), c).numpy()
    np.testing.assert_allclose(m, m_ref, rtol=tol, atol=tol * np.abs(m_ref).max())
    np.testing.assert_allclose(v, v_ref, rtol=2e-3, atol=2e-3 * np.abs(v_ref).max())
    # the LOVE variance upper-bounds the exact one, which the oracle matches
    v_exact = predcache.predict_var_exact(port, torch.as_tensor(Z), precond_rank=20,
                                          pred_tol=1e-6, xstar_chunk=16).numpy()
    v_exact_ref = np.asarray(ref_predcache.predict_var_exact(
        ref, jnp.asarray(Z), precond_rank=20, pred_tol=1e-6, xstar_chunk=16))
    np.testing.assert_allclose(v_exact, v_exact_ref, rtol=2e-3,
                               atol=2e-3 * np.abs(v_exact_ref).max())
    assert (v >= v_exact - 1e-4).all()
