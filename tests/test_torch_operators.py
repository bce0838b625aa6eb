"""repro_torch.core.operators against repro.core.operators: the same
backends on the same numpy inputs, at the conformance grid
(`tests/test_conformance.py`). The reference's pallas backend runs its
kernels in interpret mode; the port's, on the CPU, their plain versions.
The fused backend's contract is fp32 math at every operand dtype, so its
rows are held to fp32 tolerances even on fp64, as in the reference.
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
from repro_torch.core.operators import OperatorConfig, make_operator
from repro_torch.interop import params_from_numpy

BACKENDS = ("dense", "partitioned", "pallas")
KERNELS = ("rbf", "matern32", "matern52", "0.5*rbf + matern32")
DTYPES = ("float32", "float64")
SHAPES = ((64, 2), (96, 5))
MAT_TOL = {"float32": 2e-4, "float64": 1e-9}


def _tol(backend, dtype):
    return MAT_TOL["float32" if backend == "pallas" else dtype]


def _problem(kernel, dtype, n, d, t=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(dtype)
    V = rng.normal(size=(n, t)).astype(dtype)
    R = rng.normal(size=(n, t)).astype(dtype)
    Z = rng.normal(size=(n // 3, d)).astype(dtype)
    p_ref = ref_init(kernel, noise=0.3, dtype=jnp.dtype(dtype))
    return X, V, R, Z, p_ref, params_from_numpy(jax.tree.map(np.asarray, p_ref))


def _ops(backend, kernel, X, p_ref, p, **kw):
    ref = ref_make(RefConfig(kernel=kernel, backend=backend, row_block=32,
                             interpret=True, **kw), jnp.asarray(X), p_ref)
    port = make_operator(OperatorConfig(kernel=kernel, backend=backend,
                                        row_block=32, **kw), X, p, device="cpu")
    return ref, port


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"n{s[0]}d{s[1]}")
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_operator_parity(kernel, dtype, shape):
    """matvec, diag, cross_matvec and fused_matvec_dots of every ported
    backend agree with the reference's same backend."""
    X, V, R, Z, p_ref, p = _problem(kernel, dtype, *shape)
    for backend in BACKENDS:
        tol = _tol(backend, dtype)
        ref, port = _ops(backend, kernel, X, p_ref, p)
        mv = port.matvec(torch.as_tensor(V))
        assert mv.dtype == torch.as_tensor(V).dtype, backend
        np.testing.assert_allclose(mv.numpy(), np.asarray(ref.matvec(jnp.asarray(V))),
                                   rtol=tol, atol=tol, err_msg=backend)
        np.testing.assert_allclose(port.diag().numpy(), np.asarray(ref.diag()),
                                   rtol=tol, atol=tol, err_msg=backend)
        np.testing.assert_allclose(
            port.cross_matvec(torch.as_tensor(Z), torch.as_tensor(V[:, 0])).numpy(),
            np.asarray(ref.cross_matvec(jnp.asarray(Z), jnp.asarray(V[:, 0]))),
            rtol=tol, atol=tol, err_msg=backend)
        assert port.supports_fused_step == ref.supports_fused_step, backend
        out, dots = port.fused_matvec_dots(torch.as_tensor(V), torch.as_tensor(R))
        out_ref, dots_ref = ref.fused_matvec_dots(jnp.asarray(V), jnp.asarray(R))
        np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), rtol=tol,
                                   atol=tol, err_msg=backend)
        dots_ref = np.asarray(dots_ref, np.float64)
        np.testing.assert_allclose(dots.numpy(), dots_ref, rtol=10 * tol,
                                   atol=10 * tol * np.abs(dots_ref).max(),
                                   err_msg=f"{backend} dots")


@pytest.mark.parametrize("backend", BACKENDS)
def test_bf16_compute_parity(backend):
    """compute_dtype="bfloat16": bf16 operands, fp32 accumulation, on both
    sides; the tolerance is bf16's (a K entry one fp32 ulp apart may round
    to neighbouring bf16 values)."""
    X, V, _, Z, p_ref, p = _problem("0.5*rbf + matern32", "float32", 96, 5)
    ref, port = _ops(backend, "0.5*rbf + matern32", X, p_ref, p,
                     compute_dtype="bfloat16")
    for got, want in (
            (port.matvec(torch.as_tensor(V)), ref.matvec(jnp.asarray(V))),
            (port.cross_matvec(torch.as_tensor(Z), torch.as_tensor(V)),
             ref.cross_matvec(jnp.asarray(Z), jnp.asarray(V)))):
        want = np.asarray(want)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-2,
                                   atol=2e-2 * np.abs(want).max())


def test_kernel_rows_prior_diag_and_noise_parity():
    X, _, _, Z, p_ref, p = _problem("matern52", "float64", 64, 2)
    ref, port = _ops("partitioned", "matern52", X, p_ref, p)
    Zt = torch.as_tensor(Z)
    np.testing.assert_allclose(port.kernel_rows(Zt).numpy(),
                               np.asarray(ref.kernel_rows(jnp.asarray(Z))), rtol=1e-10)
    np.testing.assert_allclose(port.prior_diag(Zt).numpy(),
                               np.asarray(ref.prior_diag(jnp.asarray(Z))), rtol=1e-12)
    assert float(port.noise()) == pytest.approx(float(ref.noise()), rel=1e-12)


def test_config_fields_match_reference():
    assert OperatorConfig._fields == RefConfig._fields
    assert OperatorConfig() == OperatorConfig(**RefConfig()._asdict())


@pytest.mark.parametrize("backend", ("sharded", "blocksparse", "nope"))
def test_unported_backends_raise(backend):
    """What no backend serves raises: the sharded backend without its mesh
    geometry (it is ported: tests/test_torch_distributed.py), an unknown
    key, and a mesh geometry on a single-device backend (blocksparse's
    distributed composition runs inside the sharded backend)."""
    X = np.zeros((8, 2), np.float32)
    p = params_from_numpy(jax.tree.map(np.asarray, ref_init("rbf")))
    geom = object() if backend == "blocksparse" else None
    with pytest.raises(ValueError):
        make_operator(OperatorConfig(kernel="rbf", backend=backend, geom=geom),
                      X, p, device="cpu")
