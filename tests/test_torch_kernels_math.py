"""repro_torch.core.kernels_math against repro.core.kernels_math.

The same seeded numpy inputs and hyperparameters go through both packages
at the conformance sizes (`tests/test_conformance.py`: SHAPES, KERNELS,
VAL_TOL/MAT_TOL).
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernels_math as ref
from repro_torch.core import kernels_math as km
from repro_torch.interop import params_from_numpy

KERNELS = ("rbf", "matern32", "matern52", "0.5*rbf + matern32")
DTYPES = ("float32", "float64")
SHAPES = ((64, 2), (96, 5))
VAL_TOL = {"float32": 3e-5, "float64": 1e-10}
MAT_TOL = {"float32": 2e-4, "float64": 1e-9}
EXPRESSIONS = ("rbf", "matern32", "0.5*rbf + matern32", "rq*linear + 2.0*wendland2",
               "scale(matern12 + matern52)*rbf", "(rbf*rbf)*rq + wendland4")


def both_params(kernel, dtype, **kw):
    """Reference params and the port's twin built from the same arrays."""
    p = ref.init_params_for(kernel, dtype=jnp.dtype(dtype), **kw)
    return p, params_from_numpy(jax.tree.map(np.asarray, p))


def _inputs(n, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(dtype), rng.normal(size=(n // 2, d)).astype(dtype)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"n{s[0]}d{s[1]}")
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_matrix_and_diag_parity(kernel, dtype, shape):
    X1, X2 = _inputs(*shape, dtype)
    p_ref, p = both_params(kernel, dtype, noise=0.3)
    tol = MAT_TOL[dtype]
    K_ref = np.asarray(ref.kernel_matrix(kernel, jnp.asarray(X1), jnp.asarray(X2), p_ref))
    K = km.kernel_matrix(kernel, torch.as_tensor(X1), torch.as_tensor(X2), p).numpy()
    np.testing.assert_allclose(K, K_ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(
        km.kernel_diag(kernel, torch.as_tensor(X1), p).numpy(),
        np.asarray(ref.kernel_diag(kernel, jnp.asarray(X1), p_ref)), rtol=tol, atol=tol)
    np.testing.assert_allclose(
        km.dense_khat(kernel, torch.as_tensor(X1), p).numpy(),
        np.asarray(ref.dense_khat(kernel, jnp.asarray(X1), p_ref)), rtol=tol, atol=tol)
    assert float(km.noise_variance(p)) == pytest.approx(
        float(ref.noise_variance(p_ref)), rel=VAL_TOL[dtype])


@pytest.mark.parametrize("kind", ref.STATIONARY_KINDS)
def test_kernel_from_sqdist_parity(kind):
    d2 = np.concatenate([[0.0, 1e-12], np.linspace(0.0, 6.0, 61)])
    alpha = 1.7 if kind == "rq" else None
    out_ref = np.asarray(ref.kernel_from_sqdist(kind, jnp.asarray(d2), alpha))
    out = km.kernel_from_sqdist(kind, torch.as_tensor(d2), alpha).numpy()
    np.testing.assert_allclose(out, out_ref, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("kind", ref.LEAF_KINDS)
def test_leaf_matrix_parity(kind):
    X1, X2 = _inputs(40, 3, "float64", seed=3)
    p_ref = ref.init_kernel_params(kind, dtype=jnp.float64, lengthscale=1.3)
    p = params_from_numpy(jax.tree.map(np.asarray, p_ref))
    K_ref = np.asarray(ref.kernel_matrix(kind, jnp.asarray(X1), jnp.asarray(X2), p_ref))
    K = km.kernel_matrix(kind, torch.as_tensor(X1), torch.as_tensor(X2), p).numpy()
    np.testing.assert_allclose(K, K_ref, rtol=1e-10, atol=1e-12)


def test_sq_dist_and_safe_dist_parity():
    X1, X2 = _inputs(64, 5, "float64", seed=4)
    X2[0] = X1[0]  # a zero distance
    d2_ref = np.asarray(ref.sq_dist(jnp.asarray(X1), jnp.asarray(X2)))
    d2 = km.sq_dist(torch.as_tensor(X1), torch.as_tensor(X2)).numpy()
    np.testing.assert_allclose(d2, d2_ref, rtol=1e-10, atol=1e-12)
    assert d2.min() >= 0.0
    np.testing.assert_allclose(km.safe_dist(torch.as_tensor(d2)).numpy(),
                               np.asarray(ref.safe_dist(jnp.asarray(d2))))


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_spec_parse_and_json_parity(expr):
    s_ref = ref.parse_kernel(expr)
    s = km.parse_kernel(expr)
    assert json.dumps(km.spec_to_json(s), sort_keys=True) == \
        json.dumps(ref.spec_to_json(s_ref), sort_keys=True)
    assert km.spec_expr(s) == ref.spec_expr(s_ref)
    assert km.spec_from_json(km.spec_to_json(s)) == s
    assert km.parse_kernel(km.spec_expr(s)) == s
    assert len(km.spec_param_nodes(s)) == len(ref.spec_param_nodes(s_ref))


@pytest.mark.parametrize("kernel", KERNELS + ("rq*linear + 2.0*wendland2",))
def test_init_params_and_normal_form_parity(kernel):
    p_ref, p = both_params(kernel, "float64", noise=0.2, lengthscale=0.9)
    for a, b in zip(jax.tree.leaves(p_ref), km_leaves(p)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    twin = km.init_params_for(kernel, noise=0.2, lengthscale=0.9, dtype=torch.float64)
    for a, b in zip(jax.tree.leaves(p_ref), km_leaves(twin)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-15)
    spec_ref, kp_ref = ref.canonicalize_kernel(kernel, p_ref)
    spec, kp = km.canonicalize_kernel(kernel, p)
    assert km.spec_to_json(spec) == ref.spec_to_json(spec_ref)
    terms_ref = ref.normalize_components(spec_ref, kp_ref)
    terms = km.normalize_components(spec, kp)
    assert [tuple(k for k, _ in t.factors) for t in terms] == \
        [tuple(k for k, _ in t.factors) for t in terms_ref]
    for t, t_ref in zip(terms, terms_ref):
        assert float(t.weight) == pytest.approx(float(t_ref.weight), rel=1e-12)


def test_params_skeleton_structure():
    spec = km.parse_kernel("0.5*rbf + rq*linear")
    skel = km.params_skeleton(spec)
    skel_ref = ref.params_skeleton(ref.parse_kernel("0.5*rbf + rq*linear"))
    assert [type(n).__name__ for n in skel.nodes] == \
        [type(n).__name__ for n in skel_ref.nodes]


def km_leaves(tree):
    out = []
    km.params_map(out.append, tree)
    return out
