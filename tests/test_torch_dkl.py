"""Deep kernel learning (`repro_torch.core.dkl`) against the reference on the
CPU in fp32.

* `init_mlp` / `mlp_apply` (GeLU's tanh approximation) and `pooled_features`
  over the reduced smollm against the reference's `mlp_apply` and the
  example's pooled features.
* `DKLModel.loss` and its gradients on the `partitioned` backend, over an
  MLP (weights from the reference's `init_mlp`, carried across by
  `mlp_params_from_numpy`) and over the reduced smollm's pooled features
  (weights from the reference's `init_params(cfg, PRNGKey(0), float32)`,
  carried across by `lm_params_from_numpy`). The reference's `exact_mll`
  draws its probes from its key, so both packages' forwards take the same
  injected preconditioner and probes (as `tests/test_torch_mll.py` does),
  built from the reference's features. The gradients reach the backbone
  through the Eq. 2 backward's g_X on both sides.
* `precompute` / `predict` through the DKL against a dense posterior, and
  the example (`examples/dkl_lm_features_torch.py --cpu`) end to end.

Tolerances: the loss within 3e-5 relative (the conformance value
tolerance); gradients rtol 5e-3 / atol 5e-4 per leaf (the Eq. 2
backward's, ROADMAP B.4); arrays within 2e-4 of their largest entry.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import functools
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.mll as ref_mll_mod
import repro_torch.core.mll as mll_mod
from repro.core import ExactGP as RefExactGP
from repro.core import ExactGPConfig as RefExactGPConfig
from repro.core import OperatorConfig as RefOperatorConfig
from repro.core import make_operator as ref_make
from repro.core.dkl import DKLModel as RefDKLModel
from repro.core.dkl import init_mlp as ref_init_mlp
from repro.core.dkl import mlp_apply as ref_mlp_apply
from repro.models import get_arch as ref_get_arch
from repro.models import init_params as ref_init_params
from repro.models.model import forward_hidden as ref_forward_hidden
from repro_torch.core.dkl import (
    DKLModel, MLPParams, init_mlp, make_mlp_dkl, mlp_apply, pooled_features)
from repro_torch.core.gp import ExactGP, ExactGPConfig
from repro_torch.core.kernels_math import (
    constant_mean, dense_khat, noise_variance, params_leaves, params_map)
from repro_torch.core.pivchol import Preconditioner
from repro_torch.interop import (
    lm_params_from_numpy, lm_reference_leaf, mlp_params_from_numpy,
    params_from_numpy)
from repro_torch.models import get_arch

ROOT = pathlib.Path(__file__).resolve().parents[1]
VAL_TOL = 3e-5
G_RTOL, G_ATOL = 5e-3, 5e-4
MAT_TOL = 2e-4
N = 64
GP_KW = dict(kernel="matern32", precond_rank=10, num_probes=8, row_block=32,
             train_cg_tol=1e-6, train_max_cg_iters=100, backend="partitioned")


def _lm_cfg(pkg_get_arch):
    # the example's backbone: smollm-360m cut to 2 layers, d 32, vocab 128
    return pkg_get_arch("smollm-360m").reduced(n_layers=2, d_model=32, vocab=128)


def _tokens_problem():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 128, size=(N, 16))
    y = (np.sin(tokens[:, ::4].mean(1) / 8.0)
         + 0.05 * rng.normal(size=N)).astype(np.float32)
    return tokens, y


def _mlp_problem():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(N, 5)).astype(np.float32)
    y = (np.sin(X @ rng.normal(size=5)) + 0.1 * rng.normal(size=N)).astype(np.float32)
    return X, y


def _ref_pooled(cfg, params, tokens):
    h, _ = ref_forward_hidden(cfg, params, {"tokens": tokens})
    return jnp.mean(h.astype(jnp.float32), axis=1)


def _inject(monkeypatch, feats_ref, gp_params_ref):
    """The reference's preconditioner and probes at its features, handed to
    both packages' MLL forwards."""
    op = ref_make(RefOperatorConfig(kernel="matern32", backend="partitioned",
                                    row_block=32), feats_ref, gp_params_ref)
    pre_ref = op.preconditioner(GP_KW["precond_rank"])
    probes_ref = pre_ref.sample(jax.random.PRNGKey(3), GP_KW["num_probes"],
                                dtype=jnp.float32)
    pre = Preconditioner(*(torch.as_tensor(np.array(a)) for a in pre_ref))
    probes = torch.as_tensor(np.array(probes_ref))
    for mod, p, z in ((ref_mll_mod, pre_ref, probes_ref), (mll_mod, pre, probes)):
        orig = mod.operator_mll_forward

        def patched(op, y, key, *, _orig=orig, _p=p, _z=z, **kw):
            return _orig(op, y, key, **{**kw, "precond": _p, "probes": _z})

        monkeypatch.setattr(mod, "operator_mll_forward", patched)


def _gp_params():
    gp = RefExactGP(RefExactGPConfig(**GP_KW))
    p_ref = gp.init_params(1, noise=0.3, dtype=jnp.float32)
    p = params_map(lambda a: a.clone().requires_grad_(),
                   params_from_numpy(jax.tree.map(np.asarray, p_ref), "cpu"))
    return gp, p_ref, p


def _check_grads(port_leaves, ref_leaves, names):
    """rtol 5e-3 / atol 5e-4 per leaf, and within 2e-4 of the leaf's largest
    entry besides: the backbone's gradients are 1e-4..1e-2, which the
    absolute tolerance alone would not hold."""
    for name, a, b in zip(names, port_leaves, ref_leaves):
        a = np.zeros(np.shape(b), np.float32) if a is None else a.numpy()
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=G_RTOL, atol=G_ATOL, err_msg=name)
        np.testing.assert_allclose(a, b, rtol=0, atol=MAT_TOL * np.abs(b).max(),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the MLP feature map
# ---------------------------------------------------------------------------


def test_init_mlp_is_he_normal_and_seeded():
    a = init_mlp(torch.Generator().manual_seed(0), (200, 300, 4), device="cpu")
    b = init_mlp(torch.Generator().manual_seed(0), (200, 300, 4), device="cpu")
    assert [w.shape for w in a.weights] == [(200, 300), (300, 4)]
    assert all(torch.equal(x, y) for x, y in zip(a.weights, b.weights))
    assert all(not torch.any(bb) for bb in a.biases)
    scale = (2.0 / 200) ** 0.5
    assert abs(float(a.weights[0].std()) - scale) < 0.05 * scale


def test_mlp_apply_matches_reference():
    p_ref = ref_init_mlp(jax.random.PRNGKey(0), (5, 16, 16, 4))
    X = np.random.default_rng(2).normal(size=(20, 5)).astype(np.float32)
    p = mlp_params_from_numpy(jax.tree.map(np.asarray, p_ref), "cpu")
    assert isinstance(p, MLPParams)
    out = mlp_apply(p, torch.as_tensor(X))
    ref = np.asarray(ref_mlp_apply(p_ref, jnp.asarray(X)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=MAT_TOL * np.abs(ref).max())
    with pytest.raises(TypeError):
        mlp_params_from_numpy((np.zeros(2),), "cpu")


@functools.lru_cache(maxsize=None)
def _lm_weights():
    cfg = _lm_cfg(ref_get_arch)
    return cfg, ref_init_params(cfg, jax.random.PRNGKey(0), jnp.float32)


def test_pooled_features_match_reference():
    ref_cfg, params = _lm_weights()
    tokens, _ = _tokens_problem()
    cfg = _lm_cfg(get_arch)
    lm = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params), "cpu")
    with torch.no_grad():
        f = pooled_features(cfg, lm, tokens, device="cpu")
    ref = np.asarray(_ref_pooled(ref_cfg, params, jnp.asarray(tokens)))
    assert f.shape == (N, 32) and f.dtype == torch.float32
    np.testing.assert_allclose(f.numpy(), ref, rtol=0,
                               atol=MAT_TOL * np.abs(ref).max())
    with pytest.raises(ValueError, match="lives on"):
        pooled_features(cfg, lm, tokens, device="meta")


# ---------------------------------------------------------------------------
# DKLModel.loss and its gradients
# ---------------------------------------------------------------------------


def test_dkl_loss_over_an_mlp_matches_reference(monkeypatch):
    X, y = _mlp_problem()
    phi_ref = ref_init_mlp(jax.random.PRNGKey(0), (5, 16, 16, 4))
    gp_ref, p_ref, p = _gp_params()
    _inject(monkeypatch, ref_mlp_apply(phi_ref, jnp.asarray(X)), p_ref)
    model_ref = RefDKLModel(gp=gp_ref, phi_apply=ref_mlp_apply)
    (v_ref, _), (g_phi_ref, g_gp_ref) = jax.value_and_grad(
        lambda phi, gp: model_ref.loss(jnp.asarray(X), jnp.asarray(y), phi, gp,
                                       jax.random.PRNGKey(9)),
        argnums=(0, 1), has_aux=True)(phi_ref, p_ref)

    phi = params_map(lambda a: a.clone().requires_grad_(),
                     mlp_params_from_numpy(jax.tree.map(np.asarray, phi_ref), "cpu"))
    model = DKLModel(gp=ExactGP(ExactGPConfig(**GP_KW), device="cpu"),
                     phi_apply=mlp_apply)
    v, aux = model.loss(torch.as_tensor(X), torch.as_tensor(y), phi, p)
    v.backward()
    assert abs(float(v.detach()) - float(v_ref)) <= VAL_TOL * abs(float(v_ref))
    _check_grads([a.grad for a in params_leaves(p)], jax.tree.leaves(g_gp_ref),
                 p_ref._fields)
    # the last bias shifts every feature alike, which a stationary kernel
    # does not see: its gradient is 0 up to rounding on both sides
    leaves, ref_leaves = params_leaves(phi), jax.tree.leaves(g_phi_ref)
    _check_grads([a.grad for a in leaves[:-1]], ref_leaves[:-1],
                 ["w0", "w1", "w2", "b0", "b1"])
    scale = max(np.abs(np.asarray(b)).max() for b in ref_leaves)
    assert float(leaves[-1].grad.abs().max()) < 1e-5 * scale
    assert np.abs(np.asarray(ref_leaves[-1])).max() < 1e-5 * scale
    assert float(aux.rel_residual.max()) <= 1e-5


def test_dkl_loss_over_the_backbone_matches_reference(monkeypatch):
    """Gradients with respect to the GP's hyperparameters and every leaf of
    the reduced smollm, through the pooled features."""
    ref_cfg, params = _lm_weights()
    tokens, y = _tokens_problem()
    gp_ref, p_ref, p = _gp_params()
    _inject(monkeypatch, _ref_pooled(ref_cfg, params, jnp.asarray(tokens)), p_ref)
    model_ref = RefDKLModel(
        gp=gp_ref, phi_apply=lambda bb, tok: _ref_pooled(ref_cfg, bb, tok))
    (v_ref, _), (g_bb_ref, g_gp_ref) = jax.value_and_grad(
        lambda bb, gp: model_ref.loss(jnp.asarray(tokens), jnp.asarray(y), bb,
                                      gp, jax.random.PRNGKey(9)),
        argnums=(0, 1), has_aux=True)(params, p_ref)

    cfg = _lm_cfg(get_arch)
    lm = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params), "cpu")
    model = DKLModel(
        gp=ExactGP(ExactGPConfig(**GP_KW), device="cpu"),
        phi_apply=lambda bb, tok: pooled_features(cfg, bb, tok, device="cpu"))
    v, _ = model.loss(tokens, torch.as_tensor(y), lm, p)
    v.backward()
    assert abs(float(v.detach()) - float(v_ref)) <= VAL_TOL * abs(float(v_ref))
    _check_grads([a.grad for a in params_leaves(p)], jax.tree.leaves(g_gp_ref),
                 p_ref._fields)
    g_bb_ref = jax.tree.map(np.asarray, g_bb_ref)
    names = [name for name, _ in lm.named_parameters()]
    _check_grads([a.grad for a in lm.parameters()],
                 [lm_reference_leaf(g_bb_ref, name) for name in names], names)
    # the backbone took a gradient (through g_X) on both sides
    assert float(lm.embed.grad.abs().max()) > 0
    assert np.abs(g_bb_ref["embed"]).max() > 0


# ---------------------------------------------------------------------------
# precompute / predict, the factory, the example
# ---------------------------------------------------------------------------


def test_dkl_predict_matches_the_dense_posterior():
    """`make_mlp_dkl`, then `precompute` and `predict` at tight tolerances
    against the closed-form posterior mean on the same features."""
    X, y = _mlp_problem()
    cfg = ExactGPConfig(**{**GP_KW, "pred_cg_tol": 1e-6, "lanczos_rank": 32})
    model, phi = make_mlp_dkl(torch.Generator().manual_seed(0), 5, feature_dim=4,
                              hidden=(16,), config=cfg, device="cpu")
    gp_params = model.gp.init_params(4, noise=0.3)
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    with torch.no_grad():
        cache = model.precompute(Xt, yt, phi, gp_params,
                                 generator=torch.Generator().manual_seed(1))
        mean, var = model.predict(Xt, Xt[:16], phi, gp_params, cache)
        F = mlp_apply(phi, Xt).double()
        p64 = params_map(lambda a: a.double(), gp_params)
        Khat = dense_khat("matern32", F, p64)
        K = Khat - noise_variance(p64) * torch.eye(N, dtype=torch.float64)
        mu = constant_mean(p64)
        want = mu + K[:16] @ torch.linalg.solve(Khat, yt.double() - mu)
    assert mean.shape == (16,) and var.shape == (16,)
    assert bool(torch.all(var > 0))
    np.testing.assert_allclose(mean.numpy(), want.numpy(), rtol=0,
                               atol=MAT_TOL * float(want.abs().max()))


def test_dkl_example_runs_on_the_cpu():
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import dkl_lm_features_torch
    finally:
        sys.path.remove(str(ROOT / "examples"))
    out = dkl_lm_features_torch.main(["--cpu"])
    assert out["reached_backbone"]
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 15
    assert out["losses"][-1] < out["losses"][0]
    assert np.isfinite(out["train_rmse"])
