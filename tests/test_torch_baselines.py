"""The paper's SGPR / SVGP baselines: the reference's tests on the port, and
parity with the reference on the same numpy params.

* The reference's `tests/test_baselines.py` (limiting cases, variational
  bounds, minibatch unbiasedness, training, predict shapes) on the port.
* Parity at the conformance sizes (`tests/test_conformance.py:53`): the
  params come from the reference's `init_*_params` and cross by
  `params_from_numpy`; values within 1e-10 (fp64) / 3e-5 (fp32) of
  max(1, |ref|), matrices and gradients (against `jax.grad`) within 1e-9 /
  2e-4 relative and absolute, the conformance tolerances.
* `fit_sgpr` / `fit_svgp` for 10 steps / 2 epochs from the same start: the
  loss traces within 1e-8 (fp64; the same Adam, the same minibatches).
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sgpr as ref_sgpr
from repro.core import svgp as ref_svgp
from repro.train.gp_trainer import fit_sgpr as ref_fit_sgpr
from repro.train.gp_trainer import fit_svgp as ref_fit_svgp
from repro_torch.core import (
    SGPRParams, init_sgpr_params, init_svgp_params, sgpr_elbo, sgpr_loss,
    sgpr_precompute, sgpr_predict, svgp_elbo, svgp_loss, svgp_predict,
)
from repro_torch.core.kernels_math import (
    dense_khat, init_params, kernel_diag, kernel_matrix, params_leaves,
    params_unflatten,
)
from repro_torch.core.mll import dense_mll
from repro_torch.interop import params_from_numpy
from repro_torch.train.gp_trainer import fit_sgpr, fit_svgp

KIND = "matern32"
SHAPES = ((64, 2), (96, 5))
DTYPES = ("float32", "float64")
VAL_TOL = {"float32": 3e-5, "float64": 1e-10}
MAT_TOL = {"float32": 2e-4, "float64": 1e-9}
CPU = "cpu"


@pytest.fixture
def data():
    """The reference's `gp_data` (tests/conftest.py): n = 200, d = 4, fp64."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 4))
    w = rng.normal(size=(4,))
    y = np.sin(X @ w) + 0.1 * rng.normal(size=200)
    return torch.as_tensor(X), torch.as_tensor(y)


# ---------------------------------------------------------------------------
# the reference's tests/test_baselines.py, on the port
# ---------------------------------------------------------------------------


def test_sgpr_full_inducing_equals_exact_mll(data):
    X, y = data
    params = init_params(noise=0.2, dtype=torch.float64)
    sp = SGPRParams(gp=params, Z=X)
    elbo = float(sgpr_elbo(KIND, X, y, sp, noise_floor=0.0))
    mll = float(dense_mll(KIND, X, y, params, noise_floor=0.0))
    assert abs(elbo - mll) < 1e-2


def test_sgpr_elbo_lower_bounds_mll(data):
    X, y = data
    params = init_params(noise=0.2, dtype=torch.float64)
    for m in (8, 32, 128):
        sp = init_sgpr_params(X, m, dtype=torch.float64, device=CPU,
                              generator=torch.Generator().manual_seed(0))
        sp = SGPRParams(gp=params, Z=sp.Z)
        elbo = float(sgpr_elbo(KIND, X, y, sp))
        assert elbo <= float(dense_mll(KIND, X, y, params)) + 1e-6


def test_sgpr_elbo_improves_with_inducing_count(data):
    """Paper Fig. 3: more inducing points -> tighter bound (monotone here
    because Z_m is nested in Z_{m'})."""
    X, y = data
    params = init_params(noise=0.2, dtype=torch.float64)
    perm = np.random.default_rng(0).permutation(X.shape[0])
    prev = -np.inf
    for m in (8, 32, 128):
        elbo = float(sgpr_elbo(KIND, X, y, SGPRParams(gp=params, Z=X[perm[:m]])))
        assert elbo >= prev - 1e-9
        prev = elbo


def test_sgpr_full_inducing_predictions_exact(data):
    X, y = data
    params = init_params(noise=0.2, dtype=torch.float64)
    sp = SGPRParams(gp=params, Z=X)
    cache = sgpr_precompute(KIND, X, y, sp)
    Xs = torch.as_tensor(np.random.default_rng(1).normal(size=(20, X.shape[1])))
    mean, var = sgpr_predict(KIND, Xs, sp, cache, include_noise=False)
    Khat = dense_khat(KIND, X, params)
    Ks = kernel_matrix(KIND, Xs, X, params)
    mean_o = Ks @ torch.linalg.solve(Khat, y)
    var_o = kernel_diag(KIND, Xs, params) - torch.sum(
        Ks * torch.linalg.solve(Khat, Ks.T).T, dim=1)
    np.testing.assert_allclose(mean.numpy(), mean_o.numpy(), atol=1e-4)
    np.testing.assert_allclose(var.numpy(), var_o.numpy(), atol=1e-4)


def test_svgp_elbo_lower_bounds_mll(data):
    X, y = data
    params = init_params(noise=0.2, dtype=torch.float64)
    vp = init_svgp_params(X, 32, dtype=torch.float64, device=CPU)
    vp = vp._replace(gp=params)
    elbo = float(svgp_elbo(KIND, X, y, vp, X.shape[0]))
    assert elbo <= float(dense_mll(KIND, X, y, params)) + 1e-6


def test_svgp_minibatch_unbiased(data):
    """E_batch[minibatch ELBO] == full-batch ELBO (same params)."""
    X, y = data
    n = X.shape[0]
    vp = init_svgp_params(X, 16, dtype=torch.float64, device=CPU)
    full = float(svgp_elbo(KIND, X, y, vp, n))
    rng = np.random.default_rng(0)
    vals = []
    for _ in range(300):
        idx = torch.as_tensor(rng.choice(n, 50, replace=False))
        vals.append(float(svgp_elbo(KIND, X[idx], y[idx], vp, n)))
    assert abs(np.mean(vals) - full) < 0.05 * abs(full)


def test_svgp_training_improves_elbo(data):
    X, y = data
    _, trace, _ = fit_svgp(KIND, X.float(), y.float(), num_inducing=16,
                           epochs=20, batch=64, lr=0.05, device=CPU)
    assert trace[-1] < trace[0]


def test_svgp_predict_shapes(data):
    X, _ = data
    vp = init_svgp_params(X, 16, dtype=torch.float64, device=CPU)
    Xs = torch.as_tensor(np.random.default_rng(1).normal(size=(7, X.shape[1])))
    mean, var = svgp_predict(KIND, Xs, vp)
    assert mean.shape == (7,) and var.shape == (7,)
    assert bool(torch.all(var > 0))


# ---------------------------------------------------------------------------
# parity with the reference on the same params
# ---------------------------------------------------------------------------


def _problem(n, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(dtype)
    y = (np.sin(X.astype(np.float64) @ rng.normal(size=d))
         + 0.1 * rng.normal(size=n)).astype(dtype)
    Xs = rng.normal(size=(11, d)).astype(dtype)
    return X, y, Xs


def _ref_sgpr_params(X, m, dtype):
    p = ref_sgpr.init_sgpr_params(jax.random.PRNGKey(1), jnp.asarray(X), m,
                                  noise=0.3, dtype=jnp.dtype(dtype))
    # move the inducing points off the data so the bound is not tight
    return p._replace(Z=p.Z + 0.05)


def _ref_svgp_params(X, m, dtype, seed=2):
    """The reference's init with a non-trivial variational posterior."""
    rng = np.random.default_rng(seed)
    p = ref_svgp.init_svgp_params(jax.random.PRNGKey(1), jnp.asarray(X), m,
                                  noise=0.3, dtype=jnp.dtype(dtype))
    raw = np.asarray(p.q_sqrt_raw) + np.tril(0.1 * rng.normal(size=(m, m)))
    return p._replace(q_mu=jnp.asarray(rng.normal(size=m), jnp.dtype(dtype)),
                      q_sqrt_raw=jnp.asarray(raw, jnp.dtype(dtype)))


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), CPU)


def _torch(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _close_value(a, b, dtype):
    a, b = float(a.detach()), float(b)
    assert abs(a - b) < VAL_TOL[dtype] * max(1.0, abs(b)), (a, b)


def _close_matrix(a, b, dtype, msg=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    tol = MAT_TOL[dtype]
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol,
                               err_msg=msg)


def _torch_grad(loss_fn, params):
    leaves = [a.detach().requires_grad_(True) for a in params_leaves(params)]
    val = loss_fn(params_unflatten(params, leaves))
    return val, torch.autograd.grad(val, leaves)


def _assert_grads(loss_port, loss_ref, p_port, p_ref, dtype):
    val, grads = _torch_grad(loss_port, p_port)
    ref_val, ref_g = jax.value_and_grad(loss_ref)(p_ref)
    _close_value(val, ref_val, dtype)
    ref_leaves, _ = jax.tree_util.tree_flatten_with_path(ref_g)
    assert len(ref_leaves) == len(grads)
    for (path, b), a in zip(ref_leaves, grads):
        _close_matrix(a, b, dtype, jax.tree_util.keystr(path))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"n{s[0]}d{s[1]}")
@pytest.mark.parametrize("dtype", DTYPES)
def test_sgpr_matches_reference(dtype, shape):
    """`sgpr_elbo`, `sgpr_precompute` / `sgpr_predict` and the gradient of
    `sgpr_loss` on the reference's params."""
    n, d = shape
    X, y, Xs = _problem(n, d, dtype)
    p_ref = _ref_sgpr_params(X, 16, dtype)
    p = _port(p_ref)
    Xt, yt, Xst = _torch(X, y, Xs)
    _close_value(sgpr_elbo(KIND, Xt, yt, p), ref_sgpr.sgpr_elbo(KIND, X, y, p_ref),
                 dtype)
    cache = sgpr_precompute(KIND, Xt, yt, p)
    ref_cache = ref_sgpr.sgpr_precompute(KIND, X, y, p_ref)
    for name, a, b in zip(cache._fields, cache, ref_cache):
        _close_matrix(a, b, dtype, name)
    mean, var = sgpr_predict(KIND, Xst, p, cache, include_noise=False)
    rm, rv = ref_sgpr.sgpr_predict(KIND, Xs, p_ref, ref_cache,
                                   include_noise=False)
    _close_matrix(mean, rm, dtype, "mean")
    _close_matrix(var, rv, dtype, "var")
    _assert_grads(lambda q: sgpr_loss(KIND, Xt, yt, q),
                  lambda q: ref_sgpr.sgpr_loss(KIND, X, y, q), p, p_ref, dtype)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"n{s[0]}d{s[1]}")
@pytest.mark.parametrize("dtype", DTYPES)
def test_svgp_matches_reference(dtype, shape):
    """`svgp_elbo` on a minibatch, `svgp_predict` and the gradient of
    `svgp_loss` on the reference's params (a random q_mu and q_sqrt)."""
    n, d = shape
    X, y, Xs = _problem(n, d, dtype)
    p_ref = _ref_svgp_params(X, 12, dtype)
    p = _port(p_ref)
    Xt, yt, Xst = _torch(X, y, Xs)
    b = n // 2
    _close_value(svgp_elbo(KIND, Xt[:b], yt[:b], p, n),
                 ref_svgp.svgp_elbo(KIND, X[:b], y[:b], p_ref, n), dtype)
    mean, var = svgp_predict(KIND, Xst, p)
    rm, rv = ref_svgp.svgp_predict(KIND, Xs, p_ref)
    _close_matrix(mean, rm, dtype, "mean")
    _close_matrix(var, rv, dtype, "var")
    _assert_grads(lambda q: svgp_loss(KIND, Xt[:b], yt[:b], q, n),
                  lambda q: ref_svgp.svgp_loss(KIND, X[:b], y[:b], q, n),
                  p, p_ref, dtype)


def test_failed_cholesky_gives_nan_as_the_reference():
    """Coinciding inducing points at outputscale 100 in fp32 leave K_mm
    singular (the 1e-6 jitter is below its rounding): both packages return
    a NaN bound, neither raises nor repairs."""
    X, y, _ = _problem(64, 2, "float32")
    p_ref = ref_sgpr.init_sgpr_params(jax.random.PRNGKey(0), jnp.asarray(X), 8,
                                      dtype=jnp.float32)
    Z = np.repeat(np.asarray(p_ref.Z)[:1], 8, axis=0)
    p_ref = p_ref._replace(Z=jnp.asarray(Z),
                           gp=p_ref.gp._replace(
                               raw_outputscale=jnp.asarray(100.0, jnp.float32)))
    assert np.isnan(float(ref_sgpr.sgpr_elbo(KIND, X, y, p_ref)))
    Xt, yt = _torch(X, y)
    assert np.isnan(float(sgpr_elbo(KIND, Xt, yt, _port(p_ref))))


def test_fit_sgpr_matches_reference():
    X, y, _ = _problem(64, 2, "float64")
    m = 8
    init = ref_sgpr.init_sgpr_params(jax.random.PRNGKey(0), jnp.asarray(X), m,
                                     noise=0.5, dtype=jnp.float64)
    ref_p, ref_trace, _ = ref_fit_sgpr(KIND, jnp.asarray(X), jnp.asarray(y),
                                       num_inducing=m, steps=10)
    p, trace, secs = fit_sgpr(KIND, X, y, num_inducing=m, steps=10,
                              params0=_port(init), device=CPU)
    assert len(trace) == 10 and secs > 0
    np.testing.assert_allclose(trace, ref_trace, rtol=0, atol=1e-8)
    for a, b in zip(params_leaves(p), jax.tree.leaves(ref_p)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8,
                                   atol=1e-8)


def test_fit_svgp_matches_reference():
    """Two epochs of three minibatches each: the same permutations
    (`np.random.default_rng(seed)`), so the same steps."""
    X, y, _ = _problem(96, 5, "float64")
    m = 8
    init = ref_svgp.init_svgp_params(jax.random.PRNGKey(3), jnp.asarray(X), m,
                                     noise=0.5, dtype=jnp.float64)
    ref_p, ref_trace, _ = ref_fit_svgp(KIND, jnp.asarray(X), jnp.asarray(y),
                                       num_inducing=m, epochs=2, batch=32,
                                       lr=0.05, seed=3)
    p, trace, _ = fit_svgp(KIND, X, y, num_inducing=m, epochs=2, batch=32,
                           lr=0.05, seed=3, params0=_port(init), device=CPU)
    assert len(trace) == 2
    np.testing.assert_allclose(trace, ref_trace, rtol=0, atol=1e-8)
    for a, b in zip(params_leaves(p), jax.tree.leaves(ref_p)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8,
                                   atol=1e-8)


def test_baseline_inits_follow_the_reference_layout():
    """Shapes, dtypes, the q_sqrt diagonal raw 0.54132485 (softplus = 1)
    and the inducing points drawn from the rows of X by the generator."""
    X = torch.as_tensor(np.random.default_rng(0).normal(size=(40, 3)))
    ref = ref_svgp.init_svgp_params(jax.random.PRNGKey(0), jnp.asarray(X.numpy()),
                                    6, dtype=jnp.float64)
    g = torch.Generator().manual_seed(5)
    vp = init_svgp_params(X, 6, dtype=torch.float64, generator=g, device=CPU)
    for a, b in zip(params_leaves(vp), jax.tree.leaves(ref)):
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == str(b.dtype)
    np.testing.assert_array_equal(vp.q_sqrt_raw.numpy(), np.asarray(ref.q_sqrt_raw))
    rows = {tuple(r) for r in X.numpy()}
    assert all(tuple(z) in rows for z in vp.Z.numpy())
    again = init_svgp_params(X, 6, dtype=torch.float64, device=CPU,
                             generator=torch.Generator().manual_seed(5))
    assert torch.equal(again.Z, vp.Z)
    sp = init_sgpr_params(X, 50, dtype=torch.float32, device=CPU)  # m > n
    assert sp.Z.shape == (50, 3) and sp.Z.dtype == torch.float32
