"""The port's ServeFleet: the reference's eight fleet tests
(`tests/test_serve_fleet.py`) on the port, then the two packages' fleets
side by side — a reference-saved artifact served lazily, `observe` with the
same rows in both, an observed artifact served by the reference's engine,
and a blocksparse `observe` that rebuilds the reference's plan.

Cross-package tolerances are the conformance ones (float64 values 1e-10,
matrices 1e-9; float32 values 3e-5), relative to each array's largest
entry; the updated mean cache is a CG solution held at 1e-9 in float64.
Every future wait has a timeout and every fleet is closed in a `with` or
a `finally`.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OperatorConfig as RefConfig
from repro.core import init_params as ref_init_params
from repro.core import init_kernel_params as ref_init_kp
from repro.core import make_operator as ref_make
from repro.core import parse_kernel as ref_parse
from repro.serve import FleetConfig as RefFleetConfig
from repro.serve import PredictionEngine as RefEngine
from repro.serve import SchedulerConfig as RefSchedulerConfig
from repro.serve import ServeFleet as RefFleet
from repro.serve import artifact as ref_artifact
from repro_torch import obs
from repro_torch.core.kernels_math import init_params
from repro_torch.core.operators import OperatorConfig, make_operator
from repro_torch.serve import (
    FleetConfig, PredictionEngine, SchedulerConfig, ServeFleet,
    artifact_digest, fit_posterior, posterior_from_mean_cache, save_artifact,
)

TIMEOUT = 30
OP_CFG = OperatorConfig(kernel="matern32", backend="partitioned", row_block=32)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _fit(rng, n=120, d=3, seed=0):
    X = rng.normal(size=(n, d))
    w = rng.normal(size=(d,))
    y = np.sin(X @ w) + 0.1 * rng.normal(size=n)
    params = init_params(noise=0.2, dtype=torch.float64)
    op = make_operator(OP_CFG, X, params, device="cpu")
    art = fit_posterior(op, y, generator=torch.Generator().manual_seed(seed),
                        precond_rank=30, lanczos_rank=40, pred_tol=1e-3)
    return art, torch.as_tensor(X), torch.as_tensor(y), w, params


def _fleet(capacity=2):
    return ServeFleet(FleetConfig(
        capacity=capacity, chunk_size=32, warmup=False,
        scheduler=SchedulerConfig(max_batch=32, bucket_sizes=(8, 32))),
        device="cpu")


def _engine(art):
    return PredictionEngine(art, chunk_size=32, device="cpu")


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())


# -- the reference's fleet tests, on the port ---------------------------------


def test_fleet_serves_registered_artifact(rng):
    obs.registry().reset("serve.slo.")
    art, X, *_ = _fit(rng)
    with _fleet() as fleet:
        fleet.register("m", art)
        Xq = rng.normal(size=(5, X.shape[1]))
        mean, var = fleet.predict("m", Xq, timeout=TIMEOUT)
        ref_m, ref_v = _engine(art).predict(Xq)
        np.testing.assert_allclose(mean, ref_m.numpy(), rtol=1e-12)
        np.testing.assert_allclose(var, ref_v.numpy(), rtol=1e-12)
        assert fleet.resident() == ["m"]
        assert fleet.stats()["m"]["count"] == 1


def test_fleet_lru_eviction_and_reload(rng, tmp_path):
    """Capacity 2 with 3 models: the least recently used is dropped; its
    traffic reloads it from its directory with the same predictions."""
    art_a, X, *_ = _fit(rng, seed=0)
    art_b, *_ = _fit(rng, n=100, seed=1)
    art_c, *_ = _fit(rng, n=80, seed=2)
    save_artifact(str(tmp_path), art_a)
    with _fleet(capacity=2) as fleet:
        fleet.register("a", str(tmp_path))
        fleet.register("b", art_b)
        fleet.register("c", art_c)
        Xq = rng.normal(size=(4, X.shape[1]))
        ma0, _ = fleet.predict("a", Xq, timeout=TIMEOUT)
        fleet.predict("b", Xq, timeout=TIMEOUT)
        assert set(fleet.resident()) == {"a", "b"}
        fleet.predict("c", Xq, timeout=TIMEOUT)
        assert set(fleet.resident()) == {"b", "c"}  # "a" evicted (LRU)
        ma1, _ = fleet.predict("a", Xq, timeout=TIMEOUT)  # reload from disk
        np.testing.assert_allclose(ma1, ma0, rtol=1e-12)
        assert "b" not in fleet.resident()
        assert sorted(fleet.models()) == ["a", "b", "c"]


def test_fleet_shares_residency_by_digest(rng):
    """Two names over identical content share one residency slot."""
    art, X, *_ = _fit(rng)
    with _fleet(capacity=2) as fleet:
        fleet.register("x", art)
        fleet.register("y", art)
        Xq = rng.normal(size=(3, X.shape[1]))
        mx, _ = fleet.predict("x", Xq, timeout=TIMEOUT)
        my, _ = fleet.predict("y", Xq, timeout=TIMEOUT)
        np.testing.assert_array_equal(mx, my)
        assert fleet.digest("x") == fleet.digest("y")
        assert sorted(fleet.resident()) == ["x", "y"]


def test_fleet_observe_updates_posterior(rng):
    """observe() absorbs a batch: a new digest, and the served posterior
    matches a cold refit on the extended data."""
    art, X, y, w, params = _fit(rng)
    m = 12
    Xn = rng.normal(size=(m, X.shape[1]))
    yn = np.sin(Xn @ w) + 0.1 * rng.normal(size=m)
    with _fleet() as fleet:
        fleet.register("m", art)
        d0 = fleet.digest("m")
        d1 = fleet.observe("m", Xn, yn,
                           generator=torch.Generator().manual_seed(5))
        assert d1 != d0
        assert fleet.digest("m") == d1
        Xq = rng.normal(size=(6, X.shape[1]))
        mean_u, var_u = fleet.predict("m", Xq, timeout=TIMEOUT)
    X_ext = torch.cat([X, torch.as_tensor(Xn)])
    y_ext = torch.cat([y, torch.as_tensor(yn)])
    op_ext = make_operator(OP_CFG, X_ext, params, device="cpu")
    cold = fit_posterior(op_ext, y_ext, generator=torch.Generator().manual_seed(6),
                         precond_rank=30, lanczos_rank=40, pred_tol=1e-3)
    mean_c, _ = _engine(cold).predict(Xq)
    np.testing.assert_allclose(mean_u, mean_c.numpy(), atol=5e-2)
    assert var_u.shape == mean_u.shape and np.all(var_u > 0)


def test_fleet_observe_records_lineage(rng):
    art, X, y, w, params = _fit(rng)
    Xn = rng.normal(size=(8, X.shape[1]))
    with _fleet() as fleet:
        fleet.register("m", art)
        d0 = fleet.digest("m")
        fleet.observe("m", Xn, np.zeros(8))
        res = fleet._ensure("m")
        assert res.artifact.meta["n"] == X.shape[0] + 8
        assert res.artifact.meta["update_batches"] == 1
        assert res.artifact.meta["updated_from"] == d0


def test_fleet_observe_requires_targets(rng):
    """An artifact without training targets cannot absorb observations."""
    art, X, y, w, params = _fit(rng)
    op = make_operator(OP_CFG, X, params, device="cpu")
    no_y = posterior_from_mean_cache(op, art.mean_cache, lanczos_rank=40,
                                     generator=torch.Generator().manual_seed(1))
    assert not no_y.meta.get("has_y", False)
    with _fleet() as fleet:
        fleet.register("m", no_y)
        with pytest.raises(ValueError, match="has_y"):
            fleet.observe("m", np.zeros((2, X.shape[1])), np.zeros((2,)))


def test_fleet_digest_stable_and_content_sensitive(rng):
    art, *_ = _fit(rng)
    assert artifact_digest(art) == artifact_digest(art)
    bumped = art._replace(mean_cache=art.mean_cache + 1.0)
    assert artifact_digest(bumped) != artifact_digest(art)


def test_fleet_unknown_model_and_closed(rng):
    art, X, *_ = _fit(rng)
    fleet = _fleet()
    try:
        fleet.register("m", art)
        with pytest.raises(KeyError):
            fleet.predict("ghost", np.zeros((1, X.shape[1])), timeout=TIMEOUT)
    finally:
        fleet.close()
    fleet.close()  # idempotent
    with pytest.raises(RuntimeError):
        fleet.predict("m", np.zeros((1, X.shape[1])), timeout=TIMEOUT)


# -- the two packages side by side --------------------------------------------


def _ref_saved(tmp_path, dtype, n=120, d=3, seed=0):
    """A reference-fit artifact saved to a directory: (dir, X, y, params)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(dtype)
    w = rng.normal(size=d)
    y = (np.sin(X.astype(np.float64) @ w) + 0.1 * rng.normal(size=n)).astype(dtype)
    p_ref = ref_init_params(noise=0.2, dtype=jnp.dtype(dtype))
    op = ref_make(RefConfig(kernel="matern32", backend="partitioned",
                            row_block=32), jnp.asarray(X), p_ref)
    art = ref_artifact.fit_posterior(op, jnp.asarray(y), jax.random.PRNGKey(0),
                                     precond_rank=30, lanczos_rank=40,
                                     pred_tol=1e-3)
    path = str(tmp_path / "ref_art")
    ref_artifact.save_artifact(path, art)
    return path, art, w


def _ref_fleet():
    return RefFleet(RefFleetConfig(
        capacity=2, chunk_size=32, warmup=False,
        scheduler=RefSchedulerConfig(max_batch=32, bucket_sizes=(8, 32))))


def test_reference_artifact_served_lazily_with_its_digest(tmp_path):
    """A reference-saved directory registered in the port's fleet loads on
    first traffic, carries the reference's digest, and serves what the
    reference's engine does (float32 end to end)."""
    path, art_ref, _ = _ref_saved(tmp_path, "float32")
    Xq = np.random.default_rng(3).normal(size=(7, 3)).astype(np.float32)
    with _fleet() as fleet:
        fleet.register("r", path)
        assert fleet.resident() == []
        mean, var = fleet.predict("r", Xq, timeout=TIMEOUT)
        assert fleet.resident() == ["r"]
        assert fleet.digest("r") == ref_artifact.artifact_digest(art_ref)
    m_ref, v_ref = RefEngine(ref_artifact.load_artifact(path),
                             chunk_size=32).predict(jnp.asarray(Xq))
    _close(mean, m_ref, 3e-5)
    _close(var, v_ref, 3e-5)


def test_observe_matches_reference_fleet(tmp_path):
    """The same rows observed in both fleets from the same saved artifact:
    the new caches agree, and the metadata has the same keys, batch count
    and lineage."""
    path, _, w = _ref_saved(tmp_path, "float64")
    rng = np.random.default_rng(4)
    Xn = rng.normal(size=(10, 3))
    yn = np.sin(Xn @ w) + 0.1 * rng.normal(size=10)
    with _fleet() as fleet, _ref_fleet() as ref_fleet:
        fleet.register("m", path)
        ref_fleet.register("m", path)
        for i in range(2):  # the second batch extends the carried precond
            fleet.observe("m", Xn, yn)
            ref_fleet.observe("m", jnp.asarray(Xn), jnp.asarray(yn))
            Xn, yn = Xn + 0.5, yn[::-1].copy()
            if i == 0:  # both updated the same loaded content
                assert (fleet._ensure("m").artifact.meta["updated_from"]
                        == ref_fleet._ensure("m").artifact.meta["updated_from"])
        art = fleet._ensure("m").artifact
        art_ref = ref_fleet._ensure("m").artifact
        assert fleet._ensure("m").precond.L.shape == (140, 30)
    assert set(art.meta) == set(art_ref.meta)
    assert art.meta["update_batches"] == art_ref.meta["update_batches"] == 2
    assert art.meta["n"] == art_ref.meta["n"] == 140
    _close(art.mean_cache.numpy(), art_ref.mean_cache, 1e-9)
    _close(art.var_Q.numpy(), art_ref.var_Q, 1e-9)
    _close(art.var_T_chol.numpy(), art_ref.var_T_chol, 1e-9)
    np.testing.assert_array_equal(art.X.numpy(), np.asarray(art_ref.X))


def test_observed_artifact_serves_on_reference(tmp_path, rng):
    """An artifact the port's observe(save_to=...) wrote loads in the
    reference and its engine serves the port fleet's predictions."""
    art, X, y, w, _ = _fit(rng)
    Xn = rng.normal(size=(9, 3))
    yn = np.sin(Xn @ w)
    Xq = rng.normal(size=(6, 3))
    out = str(tmp_path / "observed")
    with _fleet() as fleet:
        fleet.register("m", art)
        digest = fleet.observe("m", Xn, yn, save_to=out)
        mean, var = fleet.predict("m", Xq, timeout=TIMEOUT)
    art_ref = ref_artifact.load_artifact(out)
    assert ref_artifact.artifact_digest(art_ref) == digest
    assert art_ref.meta["update_batches"] == 1
    m_ref, v_ref = RefEngine(art_ref, chunk_size=32).predict(jnp.asarray(Xq))
    _close(mean, m_ref, 1e-10)
    _close(var, v_ref, 1e-10)


def test_blocksparse_observe_rebuilds_reference_plan(tmp_path):
    """A blocksparse artifact absorbs rows that are not Morton-sorted: the
    plan is rebuilt over the extended inputs (same tile and margin) to the
    reference's digest (float32 hyperparameters), and both fleets serve
    the same updated posterior."""
    expr = "matern32 * wendland2"
    rng = np.random.default_rng(0)
    centers = rng.uniform(size=(4, 2))

    def field(n):
        X = (centers[rng.integers(0, 4, n)]
             + 0.05 * rng.normal(size=(n, 2))).astype(np.float32)
        return X, (np.sin(6 * X[:, 0]) * np.cos(4 * X[:, 1])).astype(np.float32)

    X, y = field(150)
    Xn, yn = field(20)
    p_ref = ref_init_kp(ref_parse(expr), lengthscale=0.3, radius=0.4,
                        noise=0.3, dtype=jnp.float32)
    op = ref_make(RefConfig(kernel=ref_parse(expr), backend="blocksparse",
                            row_block=32), jnp.asarray(X), p_ref)
    path = str(tmp_path / "sparse")
    ref_artifact.save_artifact(path, ref_artifact.fit_posterior(
        op, jnp.asarray(y), jax.random.PRNGKey(0), precond_rank=20,
        lanczos_rank=32, pred_tol=1e-4, max_cg_iters=200))
    Xq = field(30)[0]
    with _fleet() as fleet, _ref_fleet() as ref_fleet:
        fleet.register("s", path)
        ref_fleet.register("s", path)
        fleet.observe("s", Xn, yn)
        ref_fleet.observe("s", jnp.asarray(Xn), jnp.asarray(yn))
        plan = fleet._ensure("s").artifact.config.plan
        plan_ref = ref_fleet._ensure("s").artifact.config.plan
        assert plan.n == 170 and plan.digest == plan_ref.digest
        assert plan.num_pairs == plan_ref.num_pairs
        mean, var = fleet.predict("s", Xq, timeout=TIMEOUT)
        m_ref, v_ref = ref_fleet.predict("s", jnp.asarray(Xq), timeout=TIMEOUT)
    # two float32 solves stopped at 1e-4
    _close(mean, m_ref, 2e-3)
    _close(var, v_ref, 2e-3)
