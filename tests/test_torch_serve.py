"""The serving slice against the reference: artifacts written by one
package load in the other and serve the same predictions with the same
content digest, and the port's `serve_gp` flow matches the reference's on
the same data, the port's trained hyperparameters and Lanczos start vector;
the launcher's continuous fleet path runs to its end and reports both
models and the update.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import os
import pathlib
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GPParams as RefGPParams
from repro.core import OperatorConfig as RefConfig
from repro.core import dense_khat as ref_dense_khat
from repro.core import init_params_for as ref_init
from repro.core import make_operator as ref_make
from repro.core.pcg import pcg as ref_pcg
from repro.core.predcache import PredictionCache as RefCache
from repro.core.predcache import lanczos as ref_lanczos
from repro.core.predcache import predict_mean as ref_predict_mean
from repro.core.predcache import predict_var_cached as ref_predict_var
from repro.serve import PredictionEngine as RefEngine
from repro.data import synthetic as ref_synthetic
from repro.serve import artifact as ref_artifact
from repro.train import checkpoint as ref_checkpoint
from repro_torch.core.kernels_math import init_kernel_params
from repro_torch.core.operators import OperatorConfig, make_operator
from repro_torch.data import synthetic
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve_gp
from repro_torch.serve import (
    BatcherConfig, MicroBatcher, PredictionEngine, artifact_digest,
    fit_posterior, load_artifact, save_artifact,
)
from repro_torch.train import checkpoint


def _data(n=96, d=4, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(X @ rng.normal(size=d)) + 0.1 * rng.normal(size=n)).astype(np.float32)
    Z = (X[rng.integers(0, n, 40)] + 0.1 * rng.normal(size=(40, d))).astype(np.float32)
    return X, y, Z


def _close(a, b, rel=1e-4):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * np.abs(b).max())


@pytest.mark.parametrize("kernel", ("matern32", "0.5*rbf + matern32"))
def test_reference_artifact_serves_on_port(tmp_path, kernel):
    X, y, Z = _data()
    p_ref = ref_init(kernel, noise=0.1, dtype=jnp.float32)
    op_ref = ref_make(RefConfig(kernel=kernel, backend="partitioned", row_block=32),
                      jnp.asarray(X), p_ref)
    art_ref = ref_artifact.fit_posterior(op_ref, jnp.asarray(y), jax.random.PRNGKey(0),
                                         precond_rank=20, lanczos_rank=32)
    ref_artifact.save_artifact(str(tmp_path), art_ref)

    art = load_artifact(str(tmp_path), device="cpu")
    assert artifact_digest(art) == ref_artifact.artifact_digest(art_ref)
    assert art.config == OperatorConfig(**art_ref.config._asdict())
    for backend in ("partitioned", "pallas"):
        mean, var = PredictionEngine(art, backend=backend, chunk_size=32,
                                     device="cpu").predict(Z)
        mean_ref, var_ref = RefEngine(art_ref, backend=backend, chunk_size=32).predict(Z)
        _close(mean.numpy(), mean_ref)
        _close(var.numpy(), var_ref)


@pytest.mark.parametrize("kernel", ("matern32", "0.5*rbf + matern32"))
def test_port_artifact_serves_on_reference(tmp_path, kernel):
    X, y, Z = _data(seed=1)
    if kernel == "matern32":
        p_ref = ref_init(kernel, noise=0.1, dtype=jnp.float32)
        p = params_from_numpy(jax.tree.map(np.asarray, p_ref))
    else:
        p = init_kernel_params(kernel, noise=0.1)
    op = make_operator(OperatorConfig(kernel=kernel, backend="pallas"), X, p,
                       device="cpu")
    art = fit_posterior(op, y, precond_rank=20, lanczos_rank=32)
    save_artifact(str(tmp_path), art)

    art_ref = ref_artifact.load_artifact(str(tmp_path))
    assert ref_artifact.artifact_digest(art_ref) == artifact_digest(art)
    assert artifact_digest(load_artifact(str(tmp_path), device="cpu")) == artifact_digest(art)
    mean_ref, var_ref = RefEngine(art_ref, chunk_size=32).predict(Z)
    mean, var = PredictionEngine(art, chunk_size=32, device="cpu").predict(Z)
    _close(mean.numpy(), mean_ref)
    _close(var.numpy(), var_ref)


def test_checkpoint_keys_are_the_references(tmp_path):
    p = init_kernel_params("0.5*rbf + rq")
    tree = {"params": p, "X": torch.arange(6.0).reshape(3, 2), "y": torch.ones(3)}
    checkpoint.save_checkpoint(str(tmp_path), 7, tree, {"a": 1})
    p_ref = ref_init("0.5*rbf + rq")
    tmpl = {"params": p_ref, "X": np.zeros((3, 2), np.float32),
            "y": np.zeros(3, np.float32)}
    got, step, meta = ref_checkpoint.load_checkpoint(str(tmp_path), tmpl)
    assert step == 7 and meta == {"a": 1}
    for a, b in zip(jax.tree.leaves(got), [leaf for _, leaf in
                                           checkpoint.flatten_with_keys(tree)]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    keys = [k for k, _ in checkpoint.flatten_with_keys(tree)]
    assert keys == [jax.tree_util.keystr(path) for path, _ in
                    jax.tree_util.tree_flatten_with_path(tmpl)[0]]


def test_artifact_version_and_sparse_plan_gates(tmp_path):
    X, y, _ = _data(n=40)
    op = make_operator(OperatorConfig(kernel="rbf", backend="dense"), X,
                       params_from_numpy(jax.tree.map(np.asarray, ref_init("rbf"))),
                       device="cpu")
    art = fit_posterior(op, y, precond_rank=5, lanczos_rank=8)
    # a recorded sparsity plan is rebuilt on load and must match its digest
    bad_plan = {"tile": 8, "margin": 0.1, "assume_sorted": False, "fill": 1.0,
                "support": float("inf"), "num_pairs": 25, "digest": "0" * 40}
    save_artifact(str(tmp_path / "v"),
                  art._replace(meta={**art.meta, "sparse_plan": bad_plan}))
    with pytest.raises(ValueError, match="does not match"):
        load_artifact(str(tmp_path / "v"), device="cpu")
    with pytest.raises(FileNotFoundError):
        load_artifact(str(tmp_path / "missing"), device="cpu")


def test_micro_batcher_matches_direct_predict():
    X, y, Z = _data(seed=2)
    op = make_operator(OperatorConfig(kernel="matern32", backend="pallas"), X,
                       params_from_numpy(jax.tree.map(np.asarray, ref_init("matern32"))),
                       device="cpu")
    eng = PredictionEngine(fit_posterior(op, y, precond_rank=20, lanczos_rank=32),
                           chunk_size=64, device="cpu")
    mean, var = eng.predict(Z)
    with MicroBatcher(eng, BatcherConfig(max_batch=16, bucket_sizes=(8, 16))) as b:
        futs = [b.submit(Z[i:i + 5]) for i in range(0, 40, 5)]
        got = [f.result(timeout=60) for f in futs]
    np.testing.assert_allclose(np.concatenate([g[0] for g in got]), mean.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([g[1] for g in got]), var.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert b.requests_served == 8 and eng.rows_served >= 40


def test_serve_gp_flow_matches_reference(tmp_path):
    """The whole slice: the port's launcher trains, fits, saves and serves
    at n=256; the reference's flow at the port's trained hyperparameters
    and Lanczos start vector (its pcg + lanczos on its pallas backend)
    predicts the same variance, and a mean within what the 0.01 solve
    tolerance allows; the reference's engine serves the port's artifact the
    same."""
    art_dir = str(tmp_path / "art")
    report = serve_gp.main([
        "--device", "cpu", "--dataset", "houseelectric", "--n", "256",
        "--artifact", art_dir, "--chunk", "128", "--requests", "16",
        "--clients", "4"])
    assert report["rel_residual"] <= 0.01 and report["verify_rel_err"] <= 1e-5
    assert report["p50_ms"] > 0 and report["qps"] > 0
    art = load_artifact(art_dir, device="cpu")
    n, d = art.X.shape
    Z = art.X[:64].numpy() + 0.05

    # the reference's flow at the launcher's trained hyperparameters
    p_ref = RefGPParams(*(jnp.asarray(a.numpy()) for a in art.params))
    sp = lambda a: float(np.log1p(np.exp(np.asarray(a, np.float64))))  # noqa: E731
    hyper = report["hyperparameters"]
    assert sp(p_ref.raw_lengthscale) == pytest.approx(hyper["lengthscale"], rel=1e-6)
    assert sp(p_ref.raw_outputscale) == pytest.approx(hyper["outputscale"], rel=1e-6)
    assert float(p_ref.raw_mean) == pytest.approx(hyper["mean"], rel=1e-6)
    # trained: not the initial hyperparameters (noise 0.5)
    assert abs(hyper["noise"] - 0.5) > 1e-3
    Xj = jnp.asarray(art.X.numpy())
    op_ref = ref_make(RefConfig(kernel="matern32", backend="pallas", row_block=512),
                      Xj, p_ref)
    yc = jnp.asarray(art.y.numpy()) - p_ref.raw_mean
    res = ref_pcg(op_ref, yc[:, None], op_ref.preconditioner(art.meta["precond_rank"]).solve,
                  max_iters=400, min_iters=10, tol=0.01)
    v0 = torch.randn((n,), generator=torch.Generator().manual_seed(0))
    Q, T = ref_lanczos(op_ref.matvec, jnp.asarray(v0.numpy()), art.lanczos_rank)
    T_chol = jnp.linalg.cholesky(T + 1e-6 * jnp.eye(T.shape[0]))
    _close(art.var_T_chol.numpy(), T_chol, rel=2e-3)
    cache_ref = RefCache(res.solution[:, 0], Q, T_chol, res.rel_residual)
    mean_ref = np.asarray(ref_predict_mean(op_ref, jnp.asarray(Z), cache_ref))
    var_ref = np.asarray(ref_predict_var(op_ref, jnp.asarray(Z), cache_ref,
                                         include_noise=True))

    mean, var = PredictionEngine(art, chunk_size=128, device="cpu").predict(Z)
    _close(var.numpy(), var_ref, rel=2e-3)
    # two solves stopped at ||r|| <= 0.01 ||b|| agree to about that much
    _close(mean.numpy(), mean_ref, rel=3e-2)
    # and the port's mean cache solves the reference's dense system
    Khat = np.asarray(ref_dense_khat("matern32", Xj.astype(jnp.float64),
                                     jax.tree.map(lambda a: a.astype(jnp.float64), p_ref)))
    b = np.asarray(yc, np.float64)
    resid = np.linalg.norm(Khat @ art.mean_cache.numpy().astype(np.float64) - b)
    assert resid <= 0.02 * np.linalg.norm(b)
    mean_r, var_r = RefEngine(ref_artifact.load_artifact(art_dir), chunk_size=128).predict(Z)
    _close(mean.numpy(), mean_r)
    _close(var.numpy(), var_r)


def test_serve_gp_continuous_fleet_observes():
    """The launcher's fleet path at n = 256: two models served, an SLO
    target tracked, 8 rows observed into m0 and priced against a cold
    refit; the fleet serves what the launcher's engine does."""
    report = serve_gp.main([
        "--device", "cpu", "--dataset", "houseelectric", "--n", "256",
        "--chunk", "128", "--requests", "16", "--clients", "4",
        "--scheduler", "continuous", "--models", "2", "--observe", "8",
        "--slo-target-ms", "1000"])
    models = report["models"]
    assert set(models) == {"m0", "m1"}
    assert all(v["count"] > 0 and v["p50_ms"] > 0 for v in models.values())
    assert all(v["breaches"] == 0 and "burn_rate" in v for v in models.values())
    assert report["requests"] == 16 and report["batches"] > 0
    check = report["fleet_vs_engine"]
    assert check["mean_bitwise"] and check["var_rel"] <= 1e-5
    upd = report["observe"]
    assert upd["m"] == 8 and upd["model"] == "m0" and len(upd["digest"]) == 64
    assert upd["update_s"] > 0 and upd["refit_s"] > 0
    assert upd["update_rel_residual"] <= upd["pred_tol"]
    assert 0 < upd["warm_iters"] < upd["cold_iters"]
    assert upd["mean_vs_refit"] <= 3e-2 and upd["var_finite_positive"]
    assert upd["update_rank"] == 128 + 8
    assert upd["lock_wait_ms"] > 0


def test_dataset_draw_is_fixed_across_processes():
    """The port's generator is the reference's, seeded from a CRC32 of the
    name instead of the per-process `hash`: the reference reproduces the
    draw once given the same total seed, and two processes with different
    PYTHONHASHSEED draw the same arrays."""
    name = "houseelectric"
    s = synthetic.make_regression_dataset(name, max_points=300)
    shift = zlib.crc32(name.encode()) % 2 ** 16 - hash(name) % 2 ** 16
    r = ref_synthetic.make_regression_dataset(name, seed=shift, max_points=300)
    for a, b in zip(s, r):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(
        synthetic.make_regression_dataset(name, seed=1, max_points=300).X_train,
        s.X_train)

    code = ("import zlib\n"
            "from repro_torch.data.synthetic import make_regression_dataset\n"
            f"s = make_regression_dataset({name!r}, max_points=300)\n"
            "print(zlib.crc32(s.X_train.tobytes() + s.y_train.tobytes()))\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    want = str(zlib.crc32(s.X_train.tobytes() + s.y_train.tobytes()))
    for hash_seed in ("1", "2"):
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=300, cwd=root, env={**os.environ, "PYTHONHASHSEED": hash_seed,
                                        "PYTHONPATH": str(root / "src")})
        assert out.returncode == 0 and out.stdout.strip() == want, out.stderr
