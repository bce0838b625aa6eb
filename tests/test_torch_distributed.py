"""The distributed engine (`repro_torch.core.distributed`) on gloo worlds.

One `torch.multiprocessing.spawn` per world (tests/_torch_dist_worker.py):
4 ranks on a 2 x 2 (data x model) mesh and on a 4 x 1 mesh, every rank
joining a gloo group through a `file://` store and saving its results; the
assertions run here, against the JAX reference's single-device functions
on the same numpy inputs. fp64, n = 256 and a padded n = 250, d = 6,
matern32, both layouts (1-D: rows over every axis; 2-D: rows over data,
columns over model).

Tolerances: the MVM against `dense_khat @ V` 1e-10 (fp64) and 2e-4 of
max|out| on the fused (`pallas`) inner backend, whose chunk-accumulate
kernel computes in fp32; overlap on/off bit for bit on the chunked path;
pivoted Cholesky 1e-9; the MLL value 1e-10 relative and the Eq. 2
gradients rtol 5e-3 / atol 5e-4 (the conformance ones) against the
reference's `operator_mll_forward` / `operator_mll_backward` with the same
injected probes and preconditioner; the mean-cache solve 1e-7 against
`numpy.linalg.solve`. The pieces that need no world (the ring schedule,
the geometry, `chunk_sliced_plan`, `validate_dist_plan`,
`posterior_from_mean_cache`, `prepare_gp_data`) run in this process. The
launcher runs on a world of 1 (its CLI, a subprocess) and of 2.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import functools
import os
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OperatorConfig as RefConfig
from repro.core import dense_khat as ref_dense_khat
from repro.core import init_kernel_params as ref_init_kp
from repro.core import init_params as ref_init_params
from repro.core import make_operator as ref_make
from repro.core import parse_kernel as ref_parse
from repro.core import pivoted_cholesky as ref_pivchol
from repro.core.distributed import _ring_schedule as ref_ring_schedule
from repro.core.distributed import make_geometry as ref_make_geometry
from repro.core.mll import MLLConfig as RefMLLConfig
from repro.core.mll import operator_mll_backward as ref_backward
from repro.core.mll import operator_mll_forward as ref_forward
from repro.serve.artifact import posterior_from_mean_cache as ref_posterior
from repro.sparse import build_plan as ref_build_plan
from repro.sparse.plan import chunk_sliced_plan as ref_chunk_sliced_plan
from repro_torch.core import distributed as D
from repro_torch.core.kernels_math import init_kernel_params, params_leaves
from repro_torch.core.mll import MLLConfig
from repro_torch.core.operators import OperatorConfig, make_operator
from repro_torch.interop import params_from_numpy
from repro_torch.sparse import build_plan, chunk_sliced_plan, morton_order
from repro_torch.sparse.blocksparse import validate_dist_plan
from repro_torch.train.solver_state import WarmStartConfig, WarmStartEngine

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import _torch_dist_worker as worker  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLDS = ((2, 2), (4, 1))
NS = (256, 250)
MODES = ("1d", "2d")
SPATIAL = "matern32 * wendland2"


def _stub_mesh(shape):
    """The two attributes make_geometry reads, for either package."""
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.zeros(shape))


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(0)
    n, d = 256, 6
    X = rng.normal(size=(n, d))
    y = np.sin(X @ rng.normal(size=d)) + 0.1 * rng.normal(size=n)
    V = rng.normal(size=(n, 3))
    p_ref = ref_init_params(noise=0.2, dtype=jnp.float64)
    return X, y, V, p_ref, params_from_numpy(jax.tree.map(np.asarray, p_ref))


@functools.lru_cache(maxsize=None)
def _ref_mll(n):
    """The reference's single-device MLL with injected probes/precond."""
    X, y, _, p_ref, _ = _inputs()
    op = ref_make(RefConfig(kernel="matern32", backend="partitioned",
                            row_block=32), jnp.asarray(X[:n]), p_ref)
    pre = op.preconditioner(10)
    probes = np.asarray(pre.sample(jax.random.PRNGKey(3), 8, dtype=jnp.float64))
    (value, aux), (_, u_y, U, pinv_z), _ = ref_forward(
        op, jnp.asarray(y[:n]), None, precond=pre, probes=jnp.asarray(probes),
        precond_rank=10, num_probes=8, max_cg_iters=100, min_cg_iters=3,
        cg_tol=1e-10)
    g_X, _, g_p = ref_backward(RefMLLConfig(kernel="matern32", row_block=32),
                               jnp.asarray(X[:n]), p_ref, u_y, U, pinv_z,
                               -1.0 / n)
    inject = {"L": np.asarray(pre.L), "sigma2": np.asarray(pre.sigma2),
              "chol": np.asarray(pre.chol_inner), "probes": probes}
    return (-float(value) / n, float(aux.logdet),
            [np.asarray(a) for a in jax.tree.leaves(g_p)], np.asarray(g_X),
            inject)


def _spatial():
    rng = np.random.default_rng(4)
    n = 250
    X = rng.uniform(size=(n, 2)).astype(np.float32)
    X = X[morton_order(X)]
    V = rng.normal(size=(n, 2)).astype(np.float32)
    params = init_kernel_params(SPATIAL, lengthscale=0.2, radius=0.3, noise=0.3)
    return n, X, V, params


def _engine_inputs():
    X, y, _, _, p = _inputs()
    rng = np.random.default_rng(9)
    ps = [p, p._replace(raw_lengthscale=p.raw_lengthscale + 0.02),
          p._replace(raw_lengthscale=p.raw_lengthscale + 0.04)]
    probes = [rng.normal(size=(250, 8)), None, rng.normal(size=(250, 8))]
    return ps, probes


@pytest.fixture(scope="module", params=WORLDS, ids=lambda s: f"{s[0]}x{s[1]}")
def world(request, tmp_path_factory):
    X, y, V, _, p = _inputs()
    n, Xs, Vs, kp = _spatial()
    ps, probes = _engine_inputs()
    payload = {"shape": request.param, "X": X, "y": y, "V": V, "params": p,
               "mll": {m: _ref_mll(m)[4] for m in NS},
               "engine_params": ps, "engine_probes": probes,
               "blocksparse": {"n": n, "X": Xs, "V": Vs, "params": kp,
                               "kernel": SPATIAL}}
    outs = worker.spawn("world_cases", 4, payload,
                        tmp_path_factory.mktemp("world"))
    return request.param, outs


def _khat(n):
    X, _, _, p_ref, _ = _inputs()
    return np.asarray(ref_dense_khat("matern32", jnp.asarray(X[:n]), p_ref))


# -- the mesh and the MVM ---------------------------------------------------


def test_mesh_groups_are_row_major(world):
    shape, outs = world
    for rank, out in enumerate(outs):
        i, j = np.unravel_index(rank, shape)
        grid = np.arange(4).reshape(shape)
        assert out["groups"][("data",)] == list(grid[:, j])
        assert out["groups"][("model",)] == list(grid[i, :])
        assert out["groups"][("data", "model")] == [0, 1, 2, 3]


@pytest.mark.parametrize("overlap", (False, True), ids=("serial", "overlap"))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", NS)
def test_dist_kmvm_matches_dense(world, n, mode, overlap):
    _, outs = world
    _, _, V, _, _ = _inputs()
    want = _khat(n) @ V[:n]
    for out in outs:
        got = out["kmvm"][(n, mode, "partitioned", overlap)][:n]
        assert np.max(np.abs(got - want)) < 1e-10
        fused = out["kmvm"][(n, mode, "pallas", overlap)][:n]
        assert np.max(np.abs(fused - want)) <= 2e-4 * np.abs(want).max()


@pytest.mark.parametrize("backend", ("partitioned", "pallas"))
@pytest.mark.parametrize("n", NS)
def test_overlap_equals_serial_bit_for_bit(world, n, backend):
    """The chunked path (2-D) walks the same chunk steps in both arms; the
    operator's matvec is that path."""
    _, outs = world
    for out in outs:
        a = out["kmvm"][(n, "2d", backend, False)]
        assert np.array_equal(a, out["kmvm"][(n, "2d", backend, True)])
        assert np.array_equal(a, out["kmvm"][(n, "2d", backend, "op")])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", NS)
def test_dist_pivoted_cholesky_matches_reference(world, n, mode):
    _, outs = world
    X, _, _, p_ref, _ = _inputs()
    want = np.asarray(ref_pivchol("matern32", jnp.asarray(X[:n]), p_ref, 40))
    L = outs[0]["pivchol"][(n, mode)]
    assert np.max(np.abs(L[:n] - want)) < 1e-9
    assert np.all(L[n:] == 0.0)


# -- the MLL, the solve, the engine ----------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", NS)
def test_dist_mll_and_grads_match_reference(world, n, mode):
    _, outs = world
    loss_ref, logdet_ref, g_ref, gX_ref, _ = _ref_mll(n)
    for out in outs:
        r = out["mll"][(n, mode)]
        assert abs(r["loss"] - loss_ref) < 1e-10 * max(1.0, abs(loss_ref))
        assert abs(r["logdet"] - logdet_ref) < 1e-10 * max(1.0, abs(logdet_ref))
        for a, b, c in zip(r["grads"], r["grads_autograd"], g_ref):
            np.testing.assert_allclose(a, c, rtol=5e-3, atol=5e-4)
            np.testing.assert_allclose(b, c, rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(r["g_X"], gX_ref, rtol=0,
                                   atol=5e-3 * np.abs(gX_ref).max())
        assert int(r["iters"].max()) > 3


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", NS)
def test_mean_cache_solve_matches_numpy(world, n, mode):
    _, outs = world
    _, y, _, _, p = _inputs()
    want = np.linalg.solve(_khat(n), y[:n] - float(p.raw_mean))
    for out in outs:
        a, rel = out["solve"][(n, mode)]
        assert a.shape == (n,)
        assert np.max(np.abs(a - want)) < 1e-7
        assert float(rel.max()) <= 1e-10


def test_dist_warm_engine_follows_the_single_device_engine(world):
    """cold -> warm -> refresh: the same modes and telemetry keys as the
    single-device engine on the same data, probes and params, and the same
    losses and gradients (both solve to tol 1e-8)."""
    _, outs = world
    X, y, _, _, _ = _inputs()
    ps, probes = _engine_inputs()
    eng = WarmStartEngine(MLLConfig(kernel="matern32", precond_rank=10,
                                    num_probes=8, max_cg_iters=100,
                                    cg_tol=1e-8, row_block=32),
                          WarmStartConfig(refresh_every=2))
    ref = []
    for pk, pr in zip(ps, probes):
        loss, _, g = eng.step(torch.as_tensor(X[:250]), torch.as_tensor(y[:250]),
                              pk, probes=None if pr is None else torch.as_tensor(pr))
        ref.append((float(loss), [a.numpy() for a in params_leaves(g)]))
    modes = [t["mode"] for t in eng.telemetry]
    assert modes == ["cold", "warm", "refresh"]
    for out in outs:
        tel = out["engine"]["telemetry"]
        assert [t["mode"] for t in tel] == modes
        assert [sorted(t) for t in tel] == [sorted(t) for t in eng.telemetry]
        for st, (loss, grads) in zip(out["engine"]["steps"], ref):
            assert abs(st["loss"] - loss) < 1e-6 * max(1.0, abs(loss))
            for a, b in zip(st["grads"], grads):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_collective_bench_fns(world):
    """ppermute_ring: one +1 hop along the data axis (each rank receives the
    chunk of its -1 neighbour); psum_scatter: the reduce-scatter of d_col
    stacked copies, i.e. the sum of the chunks over the model group."""
    shape, outs = world
    grid = np.arange(4).reshape(shape)
    for rank, out in enumerate(outs):
        i, j = np.unravel_index(rank, shape)
        src = grid[(i - 1) % shape[0], j]
        np.testing.assert_array_equal(out["bench"]["ppermute_ring"],
                                      outs[src]["bench_chunk"])
        if shape[1] > 1:
            want = sum(outs[r]["bench_chunk"] for r in grid[i, :])
            np.testing.assert_allclose(out["bench"]["psum_scatter"], want,
                                       rtol=1e-15, atol=1e-15)
        else:
            assert "psum_scatter" not in out["bench"]


def test_cpu_group_refuses_a_non_cpu_operator(world):
    _, outs = world
    assert all(out["refuses_meta"] for out in outs)


# -- blocksparse ------------------------------------------------------------


@pytest.mark.parametrize("overlap", (False, True), ids=("serial", "overlap"))
@pytest.mark.parametrize("mode", MODES)
def test_dist_blocksparse_matches_single_device(world, mode, overlap):
    _, outs = world
    n, X, V, kp = _spatial()
    op = make_operator(OperatorConfig(kernel=SPATIAL, backend="blocksparse",
                                      row_block=8), X, kp, device="cpu")
    want = op.matvec(torch.as_tensor(V)).numpy()
    for out in outs:
        got = out["blocksparse"][(mode, overlap)][:n]
        assert np.max(np.abs(got - want)) <= 2e-4 * np.abs(want).max()
    if mode == "2d":
        for out in outs:
            a = out["blocksparse"][("2d", False)]
            assert np.array_equal(a, out["blocksparse"][("2d", True)])
            assert np.array_equal(a, out["blocksparse"][("2d", "op")])


# -- pieces that need no world ----------------------------------------------


@pytest.mark.parametrize("sizes", ((1,), (4,), (2, 2), (2, 3), (1, 4), (3, 1, 2)))
def test_ring_schedule_matches_reference(sizes):
    assert D._ring_schedule(sizes) == ref_ring_schedule(sizes)


@pytest.mark.parametrize("tile", (1, 8))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", (256, 250, 1001))
@pytest.mark.parametrize("shape", ((2, 2), (4, 1), (1, 1)))
def test_geometry_matches_reference_field_by_field(shape, n, mode, tile):
    kw = dict(mode=mode, row_block=64, overlap=True, tile_multiple=tile)
    ref = ref_make_geometry(_stub_mesh(shape), n, 6, **kw)
    geom = D.make_geometry(_stub_mesh(shape), n, 6, **kw)
    for field in ref._fields:
        assert getattr(geom, field) == getattr(ref, field), field
    for prop in ("n_padded", "n_local", "rows_local", "cols_local", "all_axes"):
        assert getattr(geom, prop) == getattr(ref, prop), prop


@pytest.mark.parametrize("n_chunks", (1, 2, 4, 8))
def test_chunk_sliced_plan_equals_reference(n_chunks):
    rng = np.random.default_rng(2)
    X = rng.uniform(size=(512, 2)).astype(np.float32)
    X = X[morton_order(X)]
    kp = init_kernel_params(SPATIAL, lengthscale=0.2, radius=0.25, noise=0.3)
    kp_ref = ref_init_kp(ref_parse(SPATIAL), lengthscale=0.2, radius=0.25,
                         noise=0.3, dtype=jnp.float32)
    plan = build_plan(SPATIAL, X, kp, tile=16, assume_sorted=True)
    plan_ref = ref_build_plan(ref_parse(SPATIAL), jnp.asarray(X), kp_ref,
                              tile=16, assume_sorted=True)
    assert plan.digest == plan_ref.digest
    got = chunk_sliced_plan(plan, n_chunks)
    want = ref_chunk_sliced_plan(plan_ref, n_chunks)
    assert got.kmax == want.kmax
    np.testing.assert_array_equal(got.cols, want.cols)
    np.testing.assert_array_equal(got.valid, want.valid)
    assert got.cols.dtype == want.cols.dtype and got.valid.dtype == want.valid.dtype


def test_validate_dist_plan_errors():
    rng = np.random.default_rng(3)
    X = rng.uniform(size=(64, 2)).astype(np.float32)
    kp = init_kernel_params(SPATIAL, lengthscale=0.2, radius=0.3, noise=0.3)
    geom = D.make_geometry(_stub_mesh((2, 2)), 64, 2, mode="1d",
                           tile_multiple=8)
    with pytest.raises(ValueError, match="PRE-SORTED"):
        validate_dist_plan(geom, build_plan(SPATIAL, X, kp, tile=8))
    Xs = X[morton_order(X)]
    with pytest.raises(ValueError, match="lays out"):
        validate_dist_plan(geom, build_plan(SPATIAL, Xs[:48], kp, tile=8,
                                            assume_sorted=True))
    with pytest.raises(ValueError, match="whole plan tiles"):
        validate_dist_plan(geom, build_plan(SPATIAL, Xs, kp, tile=32,
                                            assume_sorted=True))
    validate_dist_plan(geom, build_plan(SPATIAL, Xs, kp, tile=8,
                                        assume_sorted=True))
    with pytest.raises(ValueError, match="geom"):
        make_operator(OperatorConfig(backend="sharded"), X, kp, device="cpu")
    with pytest.raises(ValueError, match="backend='sharded'"):
        make_operator(OperatorConfig(backend="partitioned", geom=geom), X, kp,
                      device="cpu")


def test_posterior_from_mean_cache_matches_reference():
    """The same mean cache and Lanczos start vector through both packages'
    `posterior_from_mean_cache` on the single-device operator."""
    from repro_torch.serve import posterior_from_mean_cache

    X, y, _, p_ref, p = _inputs()
    Khat = _khat(256)
    a = np.linalg.solve(Khat, y - float(p.raw_mean))
    key = jax.random.PRNGKey(5)
    ref_op = ref_make(RefConfig(kernel="matern32", backend="partitioned",
                                row_block=64), jnp.asarray(X), p_ref)
    ref = ref_posterior(ref_op, jnp.asarray(a), key, y=jnp.asarray(y),
                        lanczos_rank=32, solve_rel_residual=1e-9)
    v0 = np.array(jax.random.normal(key, (256,), jnp.float64))
    op = make_operator(OperatorConfig(kernel="matern32", backend="partitioned",
                                      row_block=64), X, p, device="cpu")
    art = posterior_from_mean_cache(op, torch.as_tensor(a), v0=torch.as_tensor(v0),
                                    y=y, lanczos_rank=32, solve_rel_residual=1e-9)
    np.testing.assert_array_equal(art.mean_cache.numpy(), np.asarray(ref.mean_cache))
    np.testing.assert_allclose(art.var_Q.numpy(), np.asarray(ref.var_Q),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(art.var_T_chol.numpy(), np.asarray(ref.var_T_chol),
                               rtol=1e-9, atol=1e-9)
    assert art.meta == ref.meta
    no_y = posterior_from_mean_cache(op, torch.as_tensor(a), v0=torch.as_tensor(v0),
                                     lanczos_rank=8)
    assert not no_y.meta["has_y"] and torch.isnan(no_y.y).all()
    assert np.isnan(no_y.meta["solve_rel_residual"])


@pytest.mark.parametrize("backend", ("partitioned", "blocksparse"))
@pytest.mark.parametrize("shape", ((2, 2), (4, 1)))
def test_prepare_gp_data_pads_and_does_not_truncate(shape, backend):
    from repro_torch.launch.train import prepare_gp_data

    rng = np.random.default_rng(1)
    n = 1001
    X = rng.uniform(size=(n, 2))
    y = rng.normal(size=n)
    kp = init_kernel_params(SPATIAL, lengthscale=0.2, radius=0.3, noise=0.3)
    geom, Xp, yp, plan = prepare_gp_data(
        _stub_mesh(shape), X, y, backend=backend, gp_mode="2d", kernel=SPATIAL,
        params=kp)
    assert geom.n == n and Xp.shape[0] == geom.n_padded > n
    assert geom.n_padded % (4 * (8 if backend == "blocksparse" else 1)) == 0
    assert torch.all(Xp[n:] == 0) and torch.all(yp[n:] == 0)
    if backend == "blocksparse":
        perm = morton_order(X)
        np.testing.assert_array_equal(Xp[:n].numpy(), X[perm].astype(np.float32))
        assert plan.n == geom.n_padded and plan.tile == 8
        validate_dist_plan(geom, plan)
    else:
        np.testing.assert_array_equal(Xp[:n].numpy(), X.astype(np.float32))
        np.testing.assert_array_equal(yp[:n].numpy(), y.astype(np.float32))
        assert plan is None


# -- the launcher -------------------------------------------------------------


LAUNCH = ["--arch", "gp-exact-1m", "--device", "cpu", "--gp-n", "512",
          "--steps", "2"]


def test_launcher_world_of_one():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "")}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *LAUNCH], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines() if "nll/n=" in ln]
    assert len(lines) == 2
    for ln in lines:
        assert np.isfinite(float(ln.split("nll/n=")[1].split()[0]))


def test_launcher_world_of_two(tmp_path):
    outs = worker.spawn("launcher", 2, {"argv": LAUNCH}, tmp_path)
    for out in outs:
        assert out["n"] == 683 and out["n_padded"] == 684
        assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))
        assert out["modes"] == ["cold", "warm"]
    assert outs[0]["losses"] == outs[1]["losses"]


def test_launcher_refuses_other_archs():
    """Every registered LM arch now trains (`tests/test_torch_trainer.py`);
    an arch the registry lacks is refused before any group is joined."""
    import torch.distributed as dist

    from repro_torch.launch import train

    with pytest.raises(KeyError, match="lm-small"):
        train.main(["--arch", "lm-small", "--device", "cpu"])
    assert not dist.is_initialized()
