"""The fused kernel-MVM module of the port against the reference's Pallas
kernels (run in interpret mode, as the reference's own tests run them).

On the CPU the port's wrappers run the kernels' plain PyTorch versions, so
these hold `kmvm_plain` / `kmvm_dots_plain` and the `ops` plan around them
to `repro.kernels` at the conformance sizes and tolerances. The CUDA
kernels themselves are held to the plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kernels_math import init_params_for as ref_init
from repro.kernels import kmvm as ref_kmvm
from repro.kernels import ops as ref_ops
from repro.kernels.ref import kmvm_ref as ref_kmvm_ref
from repro_torch.kernels import kmvm, ops
from repro_torch.kernels.ref import kmvm_prescaled_ref, kmvm_ref
from repro_torch.interop import params_from_numpy

KERNELS = ("rbf", "matern32", "matern52", "0.5*rbf + matern32")
SHAPES = ((64, 2), (96, 5))
MAT_TOL = {"float32": 2e-4, "float64": 1e-9}


def _problem(kernel, n, d, t=3, seed=0, m=None):
    rng = np.random.default_rng(seed)
    m = n if m is None else m
    Xi = rng.normal(size=(m, d)).astype(np.float32)
    Xj = rng.normal(size=(n, d)).astype(np.float32)
    V = rng.normal(size=(n, t)).astype(np.float32)
    R = rng.normal(size=(n, t)).astype(np.float32)
    p_ref = ref_init(kernel, noise=0.3, dtype=jnp.float32)
    return Xi, Xj, V, R, p_ref, params_from_numpy(jax.tree.map(np.asarray, p_ref))


T = torch.as_tensor


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"n{s[0]}d{s[1]}")
@pytest.mark.parametrize("kernel", KERNELS)
def test_kmvm_block_matches_pallas_interpret(kernel, shape):
    n, d = shape
    Xi, Xj, V, _, p_ref, p = _problem(kernel, n, d, m=n - 7)
    out_ref = np.asarray(ref_ops.kmvm_block(kernel, Xi, Xj, V, p_ref, interpret=True))
    out = ops.kmvm_block(kernel, T(Xi), T(Xj), T(V), p)
    assert out.dtype == torch.float32 and out.shape == out_ref.shape
    np.testing.assert_allclose(out.numpy(), out_ref, rtol=MAT_TOL["float32"],
                               atol=MAT_TOL["float32"])
    dense = kmvm_ref(kernel, T(Xi), T(Xj), T(V), p).numpy()
    np.testing.assert_allclose(
        dense, np.asarray(ref_kmvm_ref(kernel, Xi, Xj, V, p_ref)),
        rtol=MAT_TOL["float32"], atol=MAT_TOL["float32"])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"n{s[0]}d{s[1]}")
@pytest.mark.parametrize("kernel", KERNELS)
def test_fused_matmat_matches_pallas_interpret(kernel, shape):
    n, d = shape
    _, X, V, R, p_ref, p = _problem(kernel, n, d, seed=1)
    out_ref, dots_ref = ref_ops.kmvm_fused_matmat(kernel, X, V, R, p_ref,
                                                  interpret=True)
    out, dots = ops.kmvm_fused_matmat(kernel, T(X), T(V), T(R), p)
    tol = MAT_TOL["float32"]
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), rtol=tol, atol=tol)
    dots_ref = np.asarray(dots_ref, np.float64)
    np.testing.assert_allclose(dots.numpy(), dots_ref, rtol=10 * tol,
                               atol=10 * tol * np.abs(dots_ref).max())


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("components,scalars", [
    ((("matern32",),), [1.3, 0.7]),
    ((("rq",),), [0.9, 1.2, 2.5]),
    ((("wendland2",),), [1.0, 0.3]),
    ((("rbf",), ("matern12", "matern52")), [1.0, 1.0, 0.5, 0.8, 1.4]),
    ((("wendland4",),), [2.0, 0.2]),
])
def test_kmvm_plain_matches_pallas_kernel(components, scalars, dtype):
    """The raw kernel contract: pre-scaled operands, scalar vector, fp32
    output, bf16 operands rounded as the reference's MXU operands are."""
    rng = np.random.default_rng(5)
    m, n, d, t = 40, 72, 6, 3
    Xi, Xj, V = (rng.normal(size=s).astype(np.float32) * f
                 for s, f in (((m, d), 0.6), ((n, d), 0.6), ((n, t), 1.0)))
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    out_ref = np.asarray(ref_kmvm.kmvm_pallas(
        components, jnp.asarray(Xi, jdt), jnp.asarray(Xj, jdt), jnp.asarray(V, jdt),
        jnp.asarray([scalars], jnp.float32), bm=m, bn=n, interpret=True,
        compute_dtype=dtype))
    args = (T(Xi).to(tdt), T(Xj).to(tdt), T(V).to(tdt))
    out = kmvm.kmvm_fused(components, *args, torch.tensor(scalars))
    tol = 5e-2 if dtype == "bfloat16" else MAT_TOL["float32"]
    np.testing.assert_allclose(out.numpy(), out_ref, rtol=tol,
                               atol=tol * np.abs(out_ref).max())
    assert kmvm.scalar_layout(components) == ref_kmvm.scalar_layout(components)


def test_kmvm_dots_plain_matches_pallas_kernel():
    rng = np.random.default_rng(6)
    m, d, t = 64, 4, 2
    X = rng.normal(size=(m, d)).astype(np.float32)
    V, Vrow, R = (rng.normal(size=(m, t)).astype(np.float32) for _ in range(3))
    components, scalars = (("rbf",), ("matern32",)), [1.0, 1.0, 0.7, 1.6]
    out_ref, dots_ref = ref_kmvm.kmvm_pallas_dots(
        components, X, X, V, Vrow, R, jnp.asarray([scalars], jnp.float32),
        bm=32, bn=m, interpret=True)
    out, dots = kmvm.kmvm_fused_dots(components, T(X), T(X), T(V), T(Vrow), T(R),
                                     torch.tensor(scalars))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(dots.numpy(), np.asarray(dots_ref).sum(0)[:4],
                               rtol=2e-4, atol=2e-4)


def test_prescaled_ref_is_one_component_kernel():
    rng = np.random.default_rng(8)
    Xi, Xj, V = (T(rng.normal(size=s).astype(np.float32)) for s in ((20, 3), (30, 3), (30, 2)))
    out = kmvm.kmvm_fused((("matern52",),), Xi, Xj, V, torch.tensor([1.0, 1.0]))
    np.testing.assert_allclose(out.numpy(), kmvm_prescaled_ref("matern52", Xi, Xj, V).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel,ard", [
    ("matern32", False), ("0.5*rbf + matern32", False), ("rbf + 0.3*rq", False),
    ("rbf + matern32", True), ("linear + rbf", False), ("linear*rbf + matern12", False),
])
def test_mvm_plan_parity(kernel, ard):
    kw = {"ard_dims": 3} if ard else {}
    p_ref = ref_init(kernel, dtype=jnp.float32, **kw)
    p = params_from_numpy(jax.tree.map(np.asarray, p_ref))
    plan_ref = ref_ops.mvm_plan(kernel, p_ref)
    plan = ops.mvm_plan(kernel, p)
    assert [pp.components for pp in plan.passes] == \
        [pp.components for pp in plan_ref.passes]
    assert len(plan.linear_terms) == len(plan_ref.linear_terms)
    assert plan.num_fallback_terms == plan_ref.num_fallback_terms
    for pp, pp_ref in zip(plan.passes, plan_ref.passes):
        np.testing.assert_allclose([float(s) for s in pp.scalars],
                                   [float(s) for s in pp_ref.scalars], rtol=1e-6)
    assert (ops.fused_pass_or_none(kernel, p) is None) == \
        (ref_ops.fused_pass_or_none(kernel, p_ref) is None)
    # every plan (ARD passes, thin linear matmuls, dense fallback) computes
    # the same product as the reference's
    rng = np.random.default_rng(9)
    Xi, Xj, V = (rng.normal(size=s).astype(np.float32) for s in ((30, 3), (44, 3), (44, 2)))
    out_ref = np.asarray(ref_ops.kmvm_block(kernel, Xi, Xj, V, p_ref, interpret=True))
    out = ops.kmvm_block(kernel, T(Xi), T(Xj), T(V), p).numpy()
    np.testing.assert_allclose(out, out_ref, rtol=2e-4, atol=2e-4)


def test_fp64_operands_run_fp32_and_return_fp64():
    """The dtype contract of the fused backend: fp64 in, fp32 math, fp64 out."""
    _, X, V, _, p_ref, _ = _problem("matern32", 64, 2)
    p_ref64 = ref_init("matern32", noise=0.3, dtype=jnp.float64)
    p64 = params_from_numpy(jax.tree.map(np.asarray, p_ref64))
    out = ops.kmvm_block("matern32", T(X).double(), T(X).double(), T(V).double(), p64)
    assert out.dtype == torch.float64
    out_ref = np.asarray(ref_ops.kmvm_block(
        "matern32", X.astype(np.float64), X.astype(np.float64), V.astype(np.float64),
        p_ref64, interpret=True))
    np.testing.assert_allclose(out.numpy(), out_ref, rtol=2e-4, atol=2e-4)


def test_wrapper_limits():
    X = torch.zeros((4, 2))
    with pytest.raises(ValueError):
        kmvm._spec_array(((("rbf",),) * (kmvm.MAX_COMPONENTS + 1)))
    with pytest.raises(ValueError):
        kmvm._spec_array((("rbf",) * (kmvm.MAX_FACTORS + 1),))
    with pytest.raises(ValueError):
        kmvm._spec_array((("linear",),))
    assert kmvm.kmvm_fused((("rbf",),), X, X, torch.ones((4, 1)),
                           torch.tensor([1.0, 1.0])).shape == (4, 1)


# ---------------------------------------------------------------------------
# B3: the chunk-accumulate step (the distributed ring's per-chunk launch)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("t", (1, 9, 128))
@pytest.mark.parametrize("n_chunks", (2, 3, 4))
def test_kmvm_chunk_plain_matches_pallas_chunk(n_chunks, t, dtype):
    """A walk of `kmvm_chunk_plain` over 2-4 column chunks against the
    reference's `kmvm_pallas_chunk` walk (interpret mode), same operands,
    the accumulator carried from chunk to chunk."""
    rng = np.random.default_rng(10 + n_chunks)
    m, nc, d = 64, 32, 5
    n = n_chunks * nc
    Xi, Xj, V = (rng.normal(size=s).astype(np.float32) * f
                 for s, f in (((m, d), 0.6), ((n, d), 0.6), ((n, t), 1.0)))
    components, scalars = (("rbf",), ("matern32",)), [1.0, 1.0, 0.7, 1.6]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    acc_ref = jnp.zeros((m, t), jnp.float32)
    acc = torch.zeros((m, t), dtype=torch.float32)
    before = dict(kmvm.launch_counts)
    for s in range(n_chunks):
        sl = slice(s * nc, (s + 1) * nc)
        acc_ref = ref_kmvm.kmvm_pallas_chunk(
            components, jnp.asarray(Xi, jdt), jnp.asarray(Xj[sl], jdt),
            jnp.asarray(V[sl], jdt), jnp.asarray([scalars], jnp.float32),
            acc_ref, bm=32, bn=32, interpret=True, compute_dtype=dtype)
        out = kmvm.kmvm_fused_chunk(components, T(Xi).to(tdt), T(Xj[sl]).to(tdt),
                                    T(V[sl]).to(tdt), torch.tensor(scalars), acc)
        assert out is acc
    assert kmvm.launch_counts == before  # the plain version counts nothing
    acc_ref = np.asarray(acc_ref)
    tol = 5e-2 if dtype == "bfloat16" else MAT_TOL["float32"]
    np.testing.assert_allclose(acc.numpy(), acc_ref, rtol=tol,
                               atol=tol * np.abs(acc_ref).max())


@pytest.mark.parametrize("kernel", ("matern32", "0.5*rbf + matern32", "rbf * linear"))
def test_chunk_walk_matches_single_launch(kernel):
    """`ops.kmvm_block_acc` walked over column chunks equals the single
    `kmvm_block` over all columns (fused passes, linear terms and
    dense-fallback slabs alike) within the fp32 tolerance, and a single
    chunk from a zero accumulator equals it bit for bit."""
    n, d = 96, 5
    Xi, Xj, V, _, _, p = _problem(kernel, n, d, t=9, seed=3, m=70)
    full = ops.kmvm_block(kernel, T(Xi), T(Xj), T(V), p)
    one = ops.kmvm_block_acc(kernel, T(Xi), T(Xj), T(V), p,
                             torch.zeros((70, 9)), row_block=32)
    acc = torch.zeros((70, 9))
    for j in range(0, n, 32):
        ops.kmvm_block_acc(kernel, T(Xi), T(Xj[j:j + 32]), T(V[j:j + 32]), p,
                           acc, row_block=32)
    if "linear" not in kernel:
        assert torch.equal(one, full)
    tol = MAT_TOL["float32"]
    np.testing.assert_allclose(acc.numpy(), full.numpy(), rtol=tol,
                               atol=tol * full.abs().max().item())
