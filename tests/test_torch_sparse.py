"""repro_torch.sparse against repro.sparse on the same numpy inputs.

Plans (every array, and the content digest, bit for bit), the replan
decisions, the block-sparse kernel's plain version against the reference's
Pallas kernel in interpret mode, the blocksparse operator (matvec,
cross_matvec, quad_form_grads) against the reference's operator on both of
its paths (the Pallas kernel with interpret=True, the masked jnp scan with
interpret=False), and sparse posterior artifacts across packages.
Tolerances: 2e-4 (the conformance matrix tolerance for fp32) relative to
the largest entry for MVMs and predictions; gradients 5e-3 relative per
hyperparameter leaf (the conformance gradient tolerance) and 2e-4 of the
largest entry for X gradients (fp32 summation-order noise on sums of
cancelling terms).
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OperatorConfig as RefConfig
from repro.core import init_kernel_params as ref_init
from repro.core import make_operator as ref_make
from repro.core import parse_kernel as ref_parse
from repro.kernels.ops import fused_pass_or_none as ref_fused_pass
from repro.serve import PredictionEngine as RefEngine
from repro.serve import artifact as ref_artifact
from repro.sparse import build_plan as ref_build_plan
from repro.sparse import morton_order as ref_morton
from repro.sparse import needs_replan as ref_needs_replan
from repro.sparse import plan_is_safe as ref_plan_is_safe
from repro.sparse.kmvm_sparse import kmvm_blocksparse_pallas
from repro_torch.core.kernels_math import params_leaves
from repro_torch.core.operators import OperatorConfig, make_operator
from repro_torch.interop import params_from_numpy
from repro_torch.kernels.ops import fused_pass_or_none
from repro_torch.serve import (
    PredictionEngine, fit_posterior, load_artifact, save_artifact)
from repro_torch.sparse import (
    build_plan, morton_order, needs_replan, plan_is_safe)
from repro_torch.sparse.blocksparse import fused_operands
from repro_torch.sparse.kmvm_sparse import kmvm_blocksparse
from repro_torch.sparse.plan import _softplus_f32

SHAPES = ((64, 2), (96, 5))
TOL = 2e-4
# spec -> support radius (None: no taper, the all-active plan)
SPECS = {"matern32 * wendland2": 0.4, "wendland4": 0.5,
         "0.5*rbf*wendland2 + matern32*wendland4": 0.35, "matern32": None}
PLAN_ARRAYS = ("perm", "inv_perm", "box_lo", "box_hi", "pair_rows",
               "pair_cols", "pair_first", "row_cols", "row_valid")


def _params(expr, radius, ard_dims=None):
    """(reference params, the port's) at the same float32 values."""
    p = ref_init(ref_parse(expr), ard_dims=ard_dims, lengthscale=0.3,
                 radius=radius, noise=0.3, dtype=jnp.float32)
    return p, params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def _points(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n, d)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# -- plan ---------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES + ((101, 3),),
                         ids=lambda s: f"n{s[0]}d{s[1]}")
def test_morton_order_matches_reference(shape):
    X = np.random.default_rng(1).normal(size=shape)
    np.testing.assert_array_equal(morton_order(X), ref_morton(X))


def test_softplus_matches_reference_bitwise():
    """The plan's support radius is the reference's float32 softplus, bit
    for bit (it enters the digest)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=20000) * 3,
                        rng.uniform(-30, 30, 20000),
                        rng.normal(size=5000) * 1e-3]).astype(np.float32)
    ref = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_array_equal(_softplus_f32(x).view(np.int32),
                                  ref.view(np.int32))


@pytest.mark.parametrize("tile_n", ((8, 64), (32, 96), (64, 101), (8, 517)),
                         ids=lambda s: f"tile{s[0]}n{s[1]}")
@pytest.mark.parametrize("expr", sorted(SPECS))
def test_build_plan_matches_reference(expr, tile_n):
    """Every plan array, the scalars and the digest are the reference's."""
    tile, n = tile_n
    X = _points(n, 2, seed=tile)
    p_ref, p = _params(expr, SPECS[expr])
    ref = ref_build_plan(ref_parse(expr), jnp.asarray(X), p_ref, tile=tile)
    port = build_plan(expr, X, p, tile=tile)
    for name in PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name),
                                      err_msg=name)
    for name in ("n", "d", "tile", "num_tiles", "kmax", "num_pairs", "fill",
                 "support", "support_planned", "margin", "compact"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.digest == ref.digest
    np.testing.assert_array_equal(np.diff(port.row_ptr),
                                  np.bincount(ref.pair_rows,
                                              minlength=ref.num_tiles))


@pytest.mark.parametrize("expr", ("matern32 * wendland2", "matern32"))
def test_replan_decisions_match_reference(expr):
    X = _points(96, 2)
    p_ref, p = _params(expr, SPECS[expr])
    plan_ref = ref_build_plan(ref_parse(expr), jnp.asarray(X), p_ref, tile=32)
    plan = build_plan(expr, X, p, tile=32)
    for shift in (0.0, 0.01, 0.05, 0.2, 1.0):
        q_ref = jax.tree.map(lambda a: a + shift, p_ref)
        q = params_from_numpy(jax.tree.map(np.asarray, q_ref), "cpu")
        for thr in (None, 0.05, 0.5):
            fire_ref, drift_ref = ref_needs_replan(
                plan_ref, q_ref, thr, kernel=ref_parse(expr))
            fire, drift = needs_replan(plan, q, thr, kernel=expr)
            assert fire == fire_ref, (shift, thr)
            assert drift == pytest.approx(drift_ref, rel=1e-6, abs=1e-9)
        assert plan_is_safe(plan, expr, q) == \
            ref_plan_is_safe(plan_ref, ref_parse(expr), q_ref)


# -- the kernel's plain version against the Pallas kernel -------------------


@pytest.mark.parametrize("t", (1, 9))
@pytest.mark.parametrize("tile", (8, 32))
@pytest.mark.parametrize("expr", ("matern32 * wendland2",
                                  "0.5*rbf*wendland2 + matern32*wendland4",
                                  "matern32"))
def test_blocksparse_plain_matches_pallas_interpret(expr, tile, t):
    """The same pre-scaled sorted inputs through the reference's gathered-
    grid Pallas kernel (interpret mode; rows padded to whole tiles, lanes to
    128 as it needs) and the port's plain version (no padding)."""
    n, d = 100, 2
    X = _points(n, d, seed=3)
    V = np.random.default_rng(4).normal(size=(n, t)).astype(np.float32)
    p_ref, p = _params(expr, SPECS[expr])
    plan = build_plan(expr, X, p, tile=tile)
    ppass = fused_pass_or_none(expr, p)
    Xp, Vp, scalars = fused_operands(
        ppass, torch.as_tensor(X[plan.perm]), torch.as_tensor(V[plan.perm]))
    out = kmvm_blocksparse(ppass.components, Xp, Xp, Vp, scalars,
                           torch.as_tensor(plan.row_ptr),
                           torch.as_tensor(plan.pair_cols), tile=plan.tile)
    assert ppass.components == ref_fused_pass(ref_parse(expr), p_ref).components

    def pad(A, rows, lanes):
        A = A.numpy()
        return jnp.asarray(np.pad(A, ((0, rows - A.shape[0]),
                                      (0, lanes - A.shape[1]))))

    ref = kmvm_blocksparse_pallas(
        ppass.components, pad(Xp, plan.n_pad, 128), pad(Vp, plan.n_pad, 128),
        jnp.asarray(scalars.numpy())[None, :], jnp.asarray(plan.pair_rows),
        jnp.asarray(plan.pair_cols), jnp.asarray(plan.pair_first),
        tile=plan.tile, interpret=True)
    ref = np.asarray(ref)[:n, :t]
    assert _rel(out.numpy(), ref) <= TOL


# -- the operator -------------------------------------------------------------


def _ops(expr, X, p_ref, p, tile=32, interpret=True, **kw):
    plan_ref = ref_build_plan(ref_parse(expr), jnp.asarray(X), p_ref, tile=tile)
    ref = ref_make(RefConfig(kernel=ref_parse(expr), backend="blocksparse",
                             plan=plan_ref, interpret=interpret, **kw),
                   jnp.asarray(X), p_ref)
    port = make_operator(OperatorConfig(kernel=expr, backend="blocksparse",
                                        row_block=tile, **kw), X, p,
                         device="cpu")
    return ref, port


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"n{s[0]}d{s[1]}")
@pytest.mark.parametrize("expr", sorted(SPECS))
def test_operator_matvec_matches_reference(expr, shape):
    """matvec against the reference on both of its paths (Pallas kernel,
    masked scan); a product with an ARD factor takes the masked path in
    both packages."""
    n, d = shape
    X = _points(n, d)
    V = np.random.default_rng(5).normal(size=(n, 3)).astype(np.float32)
    for ard in (None, d):
        if ard and "*" not in expr:
            continue
        p_ref, p = _params(expr, SPECS[expr], ard_dims=ard)
        for interpret in (True, False):
            ref, port = _ops(expr, X, p_ref, p, interpret=interpret)
            assert port.plan.digest == ref.plan.digest
            assert (fused_pass_or_none(expr, p) is None) == (ard is not None)
            got = port.matvec(torch.as_tensor(V)).numpy()
            assert _rel(got, np.asarray(ref.matvec(jnp.asarray(V)))) <= TOL, \
                (ard, interpret)
            got1 = port.matvec(torch.as_tensor(V[:, 0])).numpy()
            assert _rel(got1, got[:, 0]) <= 1e-6


@pytest.mark.parametrize("expr", ("matern32 * wendland2",
                                  "0.5*rbf*wendland2 + matern32*wendland4"))
def test_cross_matvec_matches_reference(expr):
    """Near queries match the reference; queries beyond every tile's support
    give exactly zero."""
    X = _points(96, 2)
    rng = np.random.default_rng(6)
    V = rng.normal(size=(96, 4)).astype(np.float32)
    near = (X[rng.integers(0, 96, 30)] + 0.05 * rng.normal(size=(30, 2))
            ).astype(np.float32)
    far = (rng.uniform(size=(10, 2)) + 3.0).astype(np.float32)
    p_ref, p = _params(expr, SPECS[expr])
    ref, port = _ops(expr, X, p_ref, p, interpret=False)
    got = port.cross_matvec(torch.as_tensor(near), torch.as_tensor(V)).numpy()
    want = np.asarray(ref.cross_matvec(jnp.asarray(near), jnp.asarray(V)))
    assert _rel(got, want) <= TOL
    zero = port.cross_matvec(torch.as_tensor(far), torch.as_tensor(V)).numpy()
    assert np.all(zero == 0.0)
    assert np.all(np.asarray(ref.cross_matvec(jnp.asarray(far),
                                              jnp.asarray(V))) == 0.0)
    mixed = np.concatenate([near[:5], far[:5]])
    got = port.cross_matvec(torch.as_tensor(mixed),
                            torch.as_tensor(V[:, 0])).numpy()
    want = np.asarray(ref.cross_matvec(jnp.asarray(mixed), jnp.asarray(V[:, 0])))
    assert _rel(got, want) <= TOL


def test_cross_launch_operands_are_cross_matvecs_launch():
    """The operands `cross_launch_operands` returns are those of the one
    block-sparse launch inside `cross_matvec` (query tiles of 64 rows
    against plan tiles of 8, three column segments, a ragged query count):
    its segments summed in order are cross_matvec's result, bit for bit,
    and match the reference."""
    from repro_torch.sparse.kmvm_sparse import kmvm_blocksparse_plain

    expr = "matern32 * wendland2"
    X = _points(517, 2, seed=7)
    rng = np.random.default_rng(8)
    V = rng.normal(size=(517, 3)).astype(np.float32)
    Z = (X[rng.integers(0, 517, 100)] + 0.02 * rng.normal(size=(100, 2))
         ).astype(np.float32)
    p_ref, p = _params(expr, SPECS[expr])
    ref, port = _ops(expr, X, p_ref, p, tile=8, interpret=False)
    args, kwargs = port.cross_launch_operands(torch.as_tensor(Z),
                                              torch.as_tensor(V))
    assert (kwargs["tile"], kwargs["row_tile"]) == (8, 64)
    nseg = args[1].shape[0] // 128
    assert nseg == 3 and args[1].shape[0] == nseg * 128
    part = kmvm_blocksparse_plain(*args, **kwargs).view(nseg, 128, 3)
    got = part[0]
    for s in range(1, nseg):
        got = got + part[s]
    want = port.cross_matvec(torch.as_tensor(Z), torch.as_tensor(V))
    assert torch.equal(got[:100], want)
    assert _rel(want.numpy(), np.asarray(ref.cross_matvec(
        jnp.asarray(Z), jnp.asarray(V)))) <= TOL


@pytest.mark.parametrize("expr", sorted(SPECS))
def test_quad_form_grads_match_reference(expr):
    """The Eq. 2 surface: hyperparameter and X gradients of
    sum_j a_j^T K_hat v_j against the reference's blocksparse operator."""
    X = _points(96, 2)
    rng = np.random.default_rng(7)
    A = rng.normal(size=(96, 3)).astype(np.float32)
    V = rng.normal(size=(96, 3)).astype(np.float32)
    p_ref, p = _params(expr, SPECS[expr])
    ref, port = _ops(expr, X, p_ref, p)
    gp_ref, gx_ref = ref.quad_form_grads(jnp.asarray(A), jnp.asarray(V))
    gp, gx = port.quad_form_grads(torch.as_tensor(A), torch.as_tensor(V))
    assert port.grad_backend == "blocksparse"
    for a, b in zip(params_leaves(gp), jax.tree.leaves(gp_ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-3,
                                   atol=5e-3 * max(1.0, float(np.abs(b).max())))
    assert _rel(gx.numpy(), np.asarray(gx_ref)) <= TOL


# -- artifacts and the engine ---------------------------------------------------


def _spatial(n, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(size=(4, 2))
    X = (centers[rng.integers(0, 4, n)]
         + 0.05 * rng.normal(size=(n, 2))).astype(np.float32)
    y = (np.sin(6 * X[:, 0]) * np.cos(4 * X[:, 1])
         + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, y


@pytest.mark.parametrize("writer", ("port", "reference"))
def test_sparse_artifact_cross_loads(tmp_path, writer):
    """A blocksparse artifact written by either package loads in the other
    with its plan rebuilt and digest-verified, and both engines (sorted
    queries) predict the same."""
    expr = "matern32 * wendland2"
    X, y = _spatial(120, 0)
    Z, _ = _spatial(50, 1)
    p_ref, p = _params(expr, 0.2)
    v0 = np.random.default_rng(2).normal(size=120).astype(np.float32)
    d = str(tmp_path / "art")
    if writer == "port":
        op = make_operator(OperatorConfig(kernel=expr, backend="blocksparse",
                                          row_block=32), X, p, device="cpu")
        art = fit_posterior(op, y, v0=torch.as_tensor(v0), precond_rank=20,
                            lanczos_rank=32, pred_tol=1e-4, max_cg_iters=200)
        save_artifact(d, art)
        digest = op.plan.digest
    else:
        op = ref_make(RefConfig(kernel=ref_parse(expr), backend="blocksparse",
                                row_block=32), jnp.asarray(X), p_ref)
        art = ref_artifact.fit_posterior(op, jnp.asarray(y),
                                         jax.random.PRNGKey(0), precond_rank=20,
                                         lanczos_rank=32, pred_tol=1e-4,
                                         max_cg_iters=200)
        ref_artifact.save_artifact(d, art)
        digest = op.config.plan.digest
    port_art = load_artifact(d, device="cpu")
    ref_art = ref_artifact.load_artifact(d)
    assert port_art.config.plan.digest == ref_art.config.plan.digest == digest
    assert port_art.meta["sparse_plan"]["digest"] == digest
    eng = PredictionEngine(port_art, device="cpu", chunk_size=16)
    ref_eng = RefEngine(ref_art, chunk_size=16)
    assert eng.sort_queries and ref_eng.sort_queries
    mean, var = eng.predict(Z)
    ref_mean, ref_var = ref_eng.predict(jnp.asarray(Z))
    assert _rel(mean.numpy(), np.asarray(ref_mean)) <= TOL
    assert _rel(var.numpy(), np.asarray(ref_var)) <= TOL
    unsorted = PredictionEngine(port_art, device="cpu", chunk_size=16,
                                sort_queries=False).predict(Z)
    assert _rel(mean.numpy(), unsorted[0].numpy()) <= 1e-5
