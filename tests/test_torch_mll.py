"""The BBMM marginal likelihood against the reference: the forward value
(Eq. 1) and the Eq. 2 backward with injected probes and preconditioner over
dense / partitioned / blocksparse x kernels at the conformance shapes
(fp32 at n = 64, d = 2; fp64 at n = 96, d = 5), the port's `exact_mll`
autograd gradients against its own `operator_mll_backward` on the same
solves (the reference's `exact_mll` draws its probes from its key, so it
cannot take injected ones), and the dense oracle.

Tolerances (the conformance ones): values 3e-5 (fp32) / 1e-10 (fp64)
relative; gradients rtol 5e-3 / atol 5e-4 (fp32) and 1e-6 / 1e-8 (fp64)
per hyperparameter leaf, X and y gradients against their largest entry.
The blocksparse backend's fused kernel computes in fp32 at every operand
dtype (as the reference's Pallas path does), so it is held to the fp32
tolerances, against the reference's Pallas path (interpret mode).
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OperatorConfig as RefConfig
from repro.core import init_kernel_params as ref_init_kp
from repro.core import init_params_for as ref_init
from repro.core import make_operator as ref_make
from repro.core import parse_kernel as ref_parse
from repro.core.mll import MLLConfig as RefMLLConfig
from repro.core.mll import dense_mll as ref_dense_mll
from repro.core.mll import operator_mll_backward as ref_backward
from repro.core.mll import operator_mll_forward as ref_forward
from repro.sparse import build_plan as ref_build_plan
from repro_torch.core.kernels_math import params_leaves, params_unflatten
from repro_torch.core.mll import (
    MLLConfig, dense_mll, exact_mll, operator_mll_backward,
    operator_mll_forward)
from repro_torch.core.operators import OperatorConfig, make_operator
from repro_torch.core.pivchol import Preconditioner
from repro_torch.interop import params_from_numpy

BACKENDS = ("dense", "partitioned", "blocksparse")
KERNELS = ("matern32", "0.5*rbf + matern32", "matern32 * wendland2")
CASES = (("float32", (64, 2)), ("float64", (96, 5)))
VAL_TOL = {"float32": 3e-5, "float64": 1e-10}
G_TOL = {"float32": (5e-3, 5e-4), "float64": (1e-6, 1e-8)}


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


def _tol_dtype(backend, dtype):
    return "float32" if backend == "blocksparse" else dtype


@functools.lru_cache(maxsize=None)
def _case(backend, kernel, dtype, shape):
    """Both packages' forward and backward on one problem (cached: the
    forward and backward tests share it)."""
    X, y, p_ref, p = _problem(kernel, dtype, *shape)
    plan = (ref_build_plan(_spec(kernel), jnp.asarray(X), p_ref, tile=32)
            if backend == "blocksparse" else None)
    ref_op = ref_make(RefConfig(kernel=_spec(kernel), backend=backend,
                                row_block=32, plan=plan, interpret=True),
                      jnp.asarray(X), p_ref)
    op = make_operator(OperatorConfig(kernel=kernel, backend=backend,
                                      row_block=32), X, p, device="cpu")
    pre_ref = ref_op.preconditioner(10)
    pre = Preconditioner(*(torch.as_tensor(np.array(a)) for a in pre_ref))
    probes = np.array(pre_ref.sample(jax.random.PRNGKey(3), 8,
                                       dtype=jnp.dtype(dtype)))
    tol = 1e-10 if _tol_dtype(backend, dtype) == "float64" else 1e-6
    kw = dict(precond_rank=10, num_probes=8, max_cg_iters=100, min_cg_iters=3,
              cg_tol=tol)
    ref = ref_forward(ref_op, jnp.asarray(y), None, precond=pre_ref,
                      probes=jnp.asarray(probes), **kw)
    port = operator_mll_forward(op, torch.as_tensor(y), None, precond=pre,
                                probes=torch.as_tensor(probes), **kw)
    cfg_ref = RefMLLConfig(kernel=_spec(kernel), backend=backend, row_block=32,
                           plan=plan)
    cfg = MLLConfig(kernel=kernel, backend=backend, row_block=32,
                    plan=getattr(op, "plan", None))
    g_ref = ref_backward(cfg_ref, jnp.asarray(X), p_ref, *ref[1][1:], 0.7)
    g = operator_mll_backward(cfg, torch.as_tensor(X), p, *port[1][1:], 0.7)
    return ref, port, g_ref, g


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-n{c[1][0]}d{c[1][1]}")
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_mll_forward_matches_reference(backend, kernel, case):
    dtype, shape = case
    ref, port, _, _ = _case(backend, kernel, dtype, shape)
    (v_ref, aux_ref), _, state_ref = ref
    (v, aux), _, state = port
    tol = VAL_TOL[_tol_dtype(backend, dtype)] * max(1.0, abs(float(v_ref)))
    assert abs(float(v) - float(v_ref)) < tol
    assert abs(float(aux.logdet) - float(aux_ref.logdet)) < tol
    np.testing.assert_allclose(state.probes.numpy(),
                               np.asarray(state_ref.probes))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-n{c[1][0]}d{c[1][1]}")
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_mll_backward_matches_reference(backend, kernel, case):
    """The Eq. 2 gradients (hyperparameters, X, y) from each package's own
    solves, same probes and preconditioner."""
    dtype, shape = case
    _, _, g_ref, g = _case(backend, kernel, dtype, shape)
    rtol, atol = G_TOL[_tol_dtype(backend, dtype)]
    for a, b in zip(params_leaves(g[2]), jax.tree.leaves(g_ref[2])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol)
    for a, b in ((g[0], g_ref[0]), (g[1], g_ref[1])):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=rtol * np.abs(b).max())


@pytest.mark.parametrize("backend", BACKENDS)
def test_exact_mll_autograd_matches_operator_backward(backend):
    """exact_mll's torch.autograd gradients are operator_mll_backward on the
    same solves (same generator seed, hence the same probes)."""
    kernel = "matern32 * wendland2"
    X, y, _, p = _problem(kernel, "float64", 96, 2)
    cfg = MLLConfig(kernel=kernel, precond_rank=10, num_probes=8,
                    max_cg_iters=100, cg_tol=1e-10, row_block=32,
                    backend=backend)
    Xt = torch.as_tensor(X).requires_grad_(True)
    yt = torch.as_tensor(y).requires_grad_(True)
    leaves = [a.clone().requires_grad_(True) for a in params_leaves(p)]
    value, aux = exact_mll(cfg, Xt, yt, params_unflatten(p, leaves),
                           torch.Generator().manual_seed(7), device="cpu")
    value.backward()
    op = make_operator(cfg.operator_config(), X, p, device="cpu")
    (v2, _), (_, u_y, U, pinv_z), _ = operator_mll_forward(
        op, torch.as_tensor(y), torch.Generator().manual_seed(7),
        precond_rank=10, num_probes=8, max_cg_iters=100, min_cg_iters=3,
        cg_tol=1e-10)
    cfg = cfg._replace(plan=getattr(op, "plan", None))
    g_X, g_y, g_p = operator_mll_backward(cfg, torch.as_tensor(X), p, u_y, U,
                                          pinv_z, 1.0)
    assert float(value.detach()) == float(v2)
    assert int(aux.cg_iterations.max()) > 0
    for a, b in zip(leaves, params_leaves(g_p)):
        assert torch.allclose(a.grad, b, rtol=1e-12, atol=1e-12)
    assert torch.allclose(Xt.grad, g_X, rtol=1e-12, atol=1e-12)
    assert torch.allclose(yt.grad, g_y, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kernel", ("matern32", "matern32 * wendland2"))
def test_dense_mll_matches_reference(kernel):
    X, y, p_ref, p = _problem(kernel, "float64", 64, 2)
    got = dense_mll(kernel, torch.as_tensor(X), torch.as_tensor(y), p)
    want = ref_dense_mll(_spec(kernel), jnp.asarray(X), jnp.asarray(y), p_ref)
    assert float(got) == pytest.approx(float(want), rel=1e-12)
