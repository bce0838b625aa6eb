"""The reference's API members and arguments that the port took on last,
held against the reference on the same inputs (numpy seeds, the
conformance sizes):

* `PredictionEngine.from_dir(directory, **kwargs)`, `.backend` and
  `.predict_mean` on artifacts the reference's `save_artifact` wrote (dense
  and blocksparse, float64): the port's means equal the reference
  engine's within 1e-10, and `predict_mean` is `predict(...)[0]` bit for
  bit. (`from_dir` with no device and no card raises:
  tests/test_torch_isolation.py.)
* `MVMPlan.num_fused_passes` / `num_fallback_terms` for the six specs of
  the reference's `tests/test_kernel_algebra.py:246-283`.
* `KernelOperator.kernel` on the `dense`, `partitioned`, `pallas` and
  `blocksparse` backends.
* `DistGeometry.vector_pspec()` equals the reference's spec, and on gloo
  worlds of 1 and 2 it is the layout of the engine's vectors: a vector
  placed as a DTensor by the spec holds on every rank the engine's chunk.
* The autotuner's `m`: the same key and split at m = 64 and m = 4096.
* `slab_block_fn_for(backend=...)`, `train_state_shardings(mesh,
  state_or_specs=...)` on a state of `meta` tensors, and a reference call
  of `kmvm_block` with `bm=` raising rather than being ignored.
* `SparsePlan.digest` of seeded float32 and float64 spatial plans equals
  the reference's, which needs the reference's float64 softplus bit for
  bit (`sparse.plan._softplus_f64`).
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OperatorConfig as RefConfig
from repro.core import init_kernel_params as ref_init
from repro.core import make_operator as ref_make
from repro.core import parse_kernel as ref_parse
from repro.core.distributed import make_geometry as ref_make_geometry
from repro.core.operators import slab_block_fn_for as ref_slab_block_fn_for
from repro.kernels.ops import mvm_plan as ref_mvm_plan
from repro.serve import PredictionEngine as RefEngine
from repro.serve import artifact as ref_artifact
from repro.sparse import build_plan as ref_build_plan
from repro_torch.core import distributed as D
from repro_torch.core.kernels_math import init_kernel_params, parse_kernel
from repro_torch.core.operators import (
    OperatorConfig,
    make_operator,
    slab_acc_fn_for,
    slab_block_fn_for,
)
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import autotune, ops
from repro_torch.serve import PredictionEngine
from repro_torch.sparse import build_plan
from repro_torch.sparse.plan import _softplus_host

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import _torch_dist_worker as worker  # noqa: E402

SPATIAL = "matern32 * wendland2"


def _port_params(p_ref):
    return params_from_numpy(jax.tree.map(np.asarray, p_ref), "cpu")


def _spatial_points(n, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(size=(4, 2))
    X = centers[rng.integers(0, 4, n)] + 0.05 * rng.normal(size=(n, 2))
    y = np.sin(6 * X[:, 0]) * np.cos(4 * X[:, 1]) + 0.1 * rng.normal(size=n)
    return X, y


# -- PredictionEngine.from_dir / backend / predict_mean ----------------------

# (backend, dtype, tolerance of the means relative to their max). The
# blocksparse operator runs its fused pass on B4's fp32 arithmetic in either
# dtype (as the reference's does on a TPU; off one, the reference takes its
# exact masked path), so its means hold at the fp32 conformance tolerance;
# its float64 artifact still needs the float64 plan digest to load.
FROM_DIR_CASES = {"dense-float64": ("dense", "float64", 1e-10),
                  "blocksparse-float32": ("blocksparse", "float32", 3e-5),
                  "blocksparse-float64": ("blocksparse", "float64", 3e-5)}


def _reference_artifact(backend, dtype, directory):
    """An artifact fitted and saved by the reference, and its queries."""
    if backend == "dense":
        rng = np.random.default_rng(0)
        X = rng.normal(size=(96, 5))
        y = np.sin(X @ rng.normal(size=5)) + 0.1 * rng.normal(size=96)
        Z = X[rng.integers(0, 96, 40)] + 0.1 * rng.normal(size=(40, 5))
        kernel = ref_parse("matern32")
        p = ref_init(kernel, lengthscale=0.8, noise=0.2,
                     dtype=getattr(jnp, dtype))
    else:
        X, y = _spatial_points(96, 0)
        Z, _ = _spatial_points(40, 1)
        kernel = ref_parse(SPATIAL)
        # at radius 0.35 numpy's float64 softplus misses XLA's last bit
        p = ref_init(kernel, lengthscale=0.3, radius=0.35, noise=0.3,
                     dtype=getattr(jnp, dtype))
    op = ref_make(RefConfig(kernel=kernel, backend=backend, row_block=32),
                  jnp.asarray(X, dtype), p)
    art = ref_artifact.fit_posterior(op, jnp.asarray(y, dtype),
                                     jax.random.PRNGKey(0), precond_rank=20,
                                     lanczos_rank=32, pred_tol=1e-8,
                                     max_cg_iters=400)
    ref_artifact.save_artifact(directory, art)
    return Z.astype(dtype)


@pytest.mark.parametrize("case", list(FROM_DIR_CASES))
def test_from_dir_serves_a_reference_artifact(tmp_path, case):
    backend, dtype, tol = FROM_DIR_CASES[case]
    d = str(tmp_path / "art")
    Z = _reference_artifact(backend, dtype, d)
    eng = PredictionEngine.from_dir(d, chunk_size=32, device="cpu")
    ref = RefEngine.from_dir(d, chunk_size=32)
    assert eng.backend == ref.backend == backend
    assert eng.op.device.type == "cpu"
    assert eng.op.dtype == getattr(torch, dtype)
    mean = eng.predict_mean(Z)
    want = np.asarray(ref.predict_mean(jnp.asarray(Z)), np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(mean.numpy(), want, rtol=tol, atol=tol * scale)
    assert torch.equal(mean, eng.predict(Z)[0])
    # the keyword arguments reach the engine
    other = "partitioned" if backend == "dense" else "blocksparse"
    eng2 = PredictionEngine.from_dir(d, backend=other, chunk_size=16,
                                     device="cpu")
    assert eng2.backend == other and eng2.chunk_size == 16
    np.testing.assert_allclose(eng2.predict_mean(Z).numpy(), want, rtol=tol,
                               atol=tol * scale)


# -- MVMPlan.num_fused_passes -------------------------------------------------


PLAN_CASES = {
    # the reference's tests/test_kernel_algebra.py:246-283
    "matern32 legacy": ("matern32", None),
    "scale(rq)": ("scale(rq)", None),
    "0.5*rbf + matern32 + scale(rq)": ("0.5*rbf + matern32 + scale(rq)", None),
    "rbf + matern32, ARD 3": ("rbf + matern32", 3),
    "rbf + 0.5*linear": ("rbf + 0.5*linear", None),
    "rbf*linear": ("rbf*linear", None),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_mvm_plan_counts_match_the_reference(case):
    from repro.core import init_params as ref_init_params
    from repro_torch.core.kernels_math import init_params

    expr, ard = PLAN_CASES[case]
    if case == "matern32 legacy":
        ref_plan = ref_mvm_plan(expr, ref_init_params(noise=0.3))
        plan = ops.mvm_plan(expr, init_params(noise=0.3))
    else:
        p_ref = ref_init(ref_parse(expr), ard_dims=ard)
        ref_plan = ref_mvm_plan(ref_parse(expr), p_ref)
        plan = ops.mvm_plan(parse_kernel(expr), _port_params(p_ref))
    assert plan.num_fused_passes == ref_plan.num_fused_passes == len(plan.passes)
    assert plan.num_fallback_terms == ref_plan.num_fallback_terms
    assert len(plan.linear_terms) == len(ref_plan.linear_terms)
    assert [q.components for q in plan.passes] == \
        [q.components for q in ref_plan.passes]


# -- KernelOperator.kernel ------------------------------------------------------


@pytest.mark.parametrize("backend", ("dense", "partitioned", "pallas", "blocksparse"))
def test_operator_kernel_is_the_configs(backend):
    X, _ = _spatial_points(64, 2)
    p_ref = ref_init(ref_parse(SPATIAL), lengthscale=0.3, radius=0.3,
                     noise=0.3, dtype=jnp.float32)
    ref_op = ref_make(RefConfig(kernel=ref_parse(SPATIAL), backend=backend,
                                row_block=32), jnp.asarray(X, jnp.float32), p_ref)
    spec = parse_kernel(SPATIAL)
    op = make_operator(OperatorConfig(kernel=spec, backend=backend, row_block=32),
                       X.astype(np.float32), _port_params(p_ref), device="cpu")
    assert op.kernel is op.config.kernel is spec
    assert op.kernel == ref_op.kernel == ref_op.config.kernel


# -- DistGeometry.vector_pspec ----------------------------------------------------


def _stub_mesh(shape):
    import types

    return types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.zeros(shape))


@pytest.mark.parametrize("shape", ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1)))
def test_vector_pspec_is_the_references(shape):
    for mode in ("1d", "2d"):
        geom = D.make_geometry(_stub_mesh(shape), 250, 3, mode=mode)
        ref = ref_make_geometry(_stub_mesh(shape), 250, 3, mode=mode)
        assert geom.vector_pspec() == tuple(ref.vector_pspec()) == (geom.all_axes,)


@pytest.mark.parametrize("world,shapes", ((1, ((1, 1),)), (2, ((2, 1), (1, 2)))),
                         ids=("world1", "world2"))
def test_vector_pspec_is_the_engines_vector_layout(tmp_path, world, shapes):
    ns = (256, 250)
    outs = worker.spawn("vector_layout", world, {"shapes": shapes, "ns": ns},
                        tmp_path)
    for shape in shapes:
        for mode in ("1d", "2d"):
            for n in ns:
                chunks = []
                for out in outs:
                    r = out[(shape, mode, n)]
                    assert r["spec"] == (r["all_axes"],)
                    assert np.array_equal(r["chunk"], r["placed"])
                    assert np.array_equal(r["gathered"],
                                          np.arange(r["gathered"].shape[0]))
                    chunks.append(r["chunk"])
                # the chunks tile the padded vector in rank order
                full = np.concatenate(chunks)
                assert np.array_equal(full, np.arange(full.shape[0]))


# -- the autotuner's m ------------------------------------------------------------


def test_autotuner_m_shares_one_key_and_split(tmp_path):
    components = (("matern32",),)
    args = dict(compute_dtype="float32", device_name="NVIDIA H100 80GB HBM3",
                cache_dir=str(tmp_path))
    calls = []

    def measure(split):
        calls.append(split)
        return {64: 0.1}.get(split, 1.0)

    autotune.clear_memo()
    try:
        keys = [autotune.cache_key(components, m, 1 << 16, 9, 1,
                                   compute_dtype="float32",
                                   device_name=args["device_name"])
                for m in (64, 4096)]
        assert keys[0] == keys[1] and "m" not in keys[0]
        small = autotune.autotune_tiles(components, 64, 1 << 16, 9, 1,
                                        measure=measure, **args)
        large = autotune.autotune_tiles(components, 4096, 1 << 16, 9, 1,
                                        measure=measure, **args)
    finally:
        autotune.clear_memo()
    assert small == large == 64
    assert calls == list(autotune.DEFAULT_CANDIDATES)  # one sweep
    assert [p.name for p in tmp_path.iterdir()] == \
        [autotune.key_hash(keys[0]) + ".json"]


# -- parameter names ----------------------------------------------------------------


def test_slab_fns_take_backend_by_keyword():
    cfg = OperatorConfig(kernel="matern32", backend="sharded",
                         compute_dtype="bfloat16")
    fn = slab_block_fn_for(backend="partitioned", config=cfg,
                           operand_dtype=torch.float32)
    assert fn is not None
    assert slab_block_fn_for(backend="pallas", config=cfg,
                             operand_dtype=torch.float32) is not None
    assert slab_acc_fn_for(backend="partitioned", config=cfg,
                           operand_dtype=torch.float32) is None
    # the reference resolves the same backends by the same keyword
    ref_cfg = RefConfig(kernel="matern32", backend="partitioned",
                        compute_dtype="bfloat16")
    assert ref_slab_block_fn_for(backend="partitioned", config=ref_cfg,
                                 operand_dtype=jnp.float32) is not None


def test_train_state_shardings_takes_meta_specs():
    from repro_torch.launch import steps
    from repro_torch.models import get_arch

    cfg = get_arch("smollm-360m").reduced()
    mesh = _stub_mesh((2, 2))
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    meta = steps.init_train_state(cfg, None, device="meta")
    assert all(p.device.type == "meta" for p in meta.params.values())
    want = steps.train_state_shardings(mesh, state)
    got = steps.train_state_shardings(mesh, state_or_specs=meta)
    assert got == want and got.params["embed"] == ("model", "data")


def test_kmvm_block_refuses_pallas_block_shapes():
    from repro_torch.core.kernels_math import init_params

    X = torch.zeros((8, 2))
    V = torch.zeros((8, 1))
    with pytest.raises(TypeError, match="bm"):
        ops.kmvm_block("matern32", X, X, V, init_params(), bm=256)
    with pytest.raises(TypeError, match="bn"):
        ops.kmvm_fused_matmat("matern32", X, V, V, init_params(), bn=256)
    with pytest.raises(TypeError, match="bm"):
        ops.pallas_block_fn("matern32", bm=256)


# -- plan digests --------------------------------------------------------------------


def test_float64_softplus_is_xlas_bit_for_bit():
    """The radius' softplus in float64 as XLA computes it on the CPU; numpy's
    own formula differs in the last bit on part of the same inputs."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(size=2048) * 3, rng.uniform(-3, 1, 2048)])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x, jnp.float64)))
    assert np.array_equal(_softplus_host(x), want)
    numpy_formula = np.maximum(x, 0) + np.log1p(np.exp(-np.abs(x)))
    assert np.count_nonzero(numpy_formula != want) > 0


DIGEST_CASES = [(dtype, expr, seed)
                for dtype in ("float32", "float64")
                for expr in (SPATIAL, "rbf * wendland2 + matern32 * wendland4")
                for seed in range(5)]


def _digest_radius(seed):
    return float(np.random.default_rng(10 + seed).uniform(0.1, 0.5))


def test_digest_cases_reach_the_last_bit():
    """Some float64 radii of the digest cases are where numpy's softplus
    misses XLA's last bit (seeds 3 and 4), so the cases test the port's
    float64 softplus and not only numpy's."""
    from repro.core.kernels_math import inv_softplus

    raw = np.array([float(inv_softplus(jnp.float64(_digest_radius(s))))
                    for s in range(5)])
    want = np.asarray(jax.nn.softplus(jnp.asarray(raw)))
    numpy_formula = np.maximum(raw, 0) + np.log1p(np.exp(-np.abs(raw)))
    assert np.count_nonzero(numpy_formula != want) >= 1
    assert np.array_equal(_softplus_host(raw), want)


@pytest.mark.parametrize("dtype,expr,seed", DIGEST_CASES)
def test_plan_digest_matches_the_reference(dtype, expr, seed):
    X, _ = _spatial_points(250, seed)
    X = X.astype(dtype)
    p_ref = ref_init(ref_parse(expr), lengthscale=0.3,
                     radius=_digest_radius(seed), noise=0.3,
                     dtype=getattr(jnp, dtype))
    ref_plan = ref_build_plan(ref_parse(expr), jnp.asarray(X), p_ref, tile=32)
    plan = build_plan(parse_kernel(expr), X, _port_params(p_ref), tile=32)
    assert plan.support_planned == ref_plan.support_planned
    assert plan.digest == ref_plan.digest
