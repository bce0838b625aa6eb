"""The plain reference against dense float64 algebra at a tiny size."""

from __future__ import annotations

import math

import pytest
import torch

from gpbench import reference as R

RAW = {"matern32": {"lengthscale": 0.3, "outputscale": -0.2, "noise": -1.5, "mean": 0.4},
       "matern32-wendland2": {"lengthscale": 0.2, "radius": -0.5, "noise": -1.0, "mean": -0.1}}


def _problem(spec, n=96, d=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    X = torch.rand((n, d), generator=g, dtype=torch.float64)
    y = torch.sin(3 * X.sum(1)) + 0.1 * torch.randn(n, generator=g, dtype=torch.float64)
    kern = R.Kernel(spec, RAW[spec], 1e-4)
    return X, y, kern


def _dense(kern, X):
    r = torch.cdist(X, X)
    return kern.block(X, X, R.FP64, r=r) + kern.noise * torch.eye(X.shape[0], dtype=X.dtype)


@pytest.mark.parametrize("spec", sorted(RAW))
@pytest.mark.parametrize("dense_limit", [1 << 16, 0])
def test_operator_matches_dense(spec, dense_limit):
    X, _, kern = _problem(spec)
    op = R.Operator(kern, X, R.FP64, dense_limit=dense_limit, block=32)
    V = torch.randn((X.shape[0], 3), dtype=torch.float64)
    torch.testing.assert_close(op.matvec(V), _dense(kern, X) @ V, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("spec", sorted(RAW))
def test_fit_and_served_answers_match_dense_solve(spec):
    X, y, kern = _problem(spec)
    n = X.shape[0]
    op = R.Operator(kern, X, R.FP64)
    v0 = torch.randn(n, dtype=torch.float64)
    c, Q, T, rel = R.fit_posterior(op, y, v0, precond_rank=10, lanczos_rank=n,
                                   tol=1e-10, max_iters=400)
    K = _dense(kern, X)
    torch.testing.assert_close(c, torch.linalg.solve(K, y - kern.mean), rtol=1e-6, atol=1e-6)
    assert rel <= 1e-10
    Z = torch.rand((7, X.shape[1]), dtype=torch.float64)
    T_chol = torch.linalg.cholesky(T + 1e-6 * torch.eye(n, dtype=torch.float64))
    mean, var = R.served(op, Z, c, Q, T_chol)
    Ks = kern.block(Z, X, R.FP64, r=torch.cdist(Z, X))
    torch.testing.assert_close(mean, kern.mean + Ks @ torch.linalg.solve(K, y - kern.mean),
                               rtol=1e-6, atol=1e-6)
    exact = kern.prior_diag() - torch.sum(Ks * torch.linalg.solve(K, Ks.T).T, 1) + kern.noise
    torch.testing.assert_close(var, exact, rtol=1e-4, atol=1e-5)
    nums = R.fit_checks(op, y, c, Q, T, v0, rel, 0.01)
    assert nums["lanczos_gap"] < 1e-8 and nums["mean_residual"] < 1e-9


@pytest.mark.parametrize("spec", sorted(RAW))
def test_bbmm_step_converged_matches_dense(spec):
    """Converged mBCG: the quadratic term, the Eq. 2 gradient against
    autograd of the dense estimator with the same probes, the exact
    log-determinant."""
    X, y, kern = _problem(spec)
    n = X.shape[0]
    op = R.Operator(kern, X, R.FP64)
    L = R.pivoted_cholesky(op, 8)
    assert R.precond_gap(op, L) < 1e-12
    P = R.Precond(L, kern.noise, R.FP64)
    Z = torch.randn((n, 4), dtype=torch.float64)
    out = R.bbmm_step(op, y, P, Z, [n] * 5)
    K = _dense(kern, X)
    quad = float((y - kern.mean) @ torch.linalg.solve(K, y - kern.mean))
    ld = float(torch.logdet(K))
    assert out.loss == pytest.approx(0.5 * (quad + out.logdet + n * math.log(2 * math.pi)) / n,
                                     rel=1e-9)
    assert R.exact_logdet(R.Operator(kern, X, R.FP64)) == pytest.approx(ld, rel=1e-10)
    # the estimator's gradient by autograd over a dense matrix
    raw = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
           for k, v in RAW[spec].items()}

    def sp(x):
        return torch.nn.functional.softplus(x)

    r = torch.cdist(X, X)
    a = math.sqrt(3.0) * r / sp(raw["lengthscale"])
    Km = (1 + a) * torch.exp(-a)
    if spec == "matern32":
        Km = sp(raw["outputscale"]) * Km
    else:
        u = r / sp(raw["radius"])
        b = torch.clamp(1 - u, min=0)
        Km = Km * b ** 4 * (4 * u + 1)
    Kh = Km + (sp(raw["noise"]) + 1e-4) * torch.eye(n, dtype=torch.float64)
    yc = y - raw["mean"]
    Pinv_z = P.solve(Z)
    u = torch.linalg.solve(Kh.detach(), torch.cat([yc.detach()[:, None], Z], 1))
    # d/dtheta of 0.5 (yc^T K^-1 yc + tr-estimate) / n with the solves held
    surrogate = 0.5 * (2 * yc @ u[:, 0] - u[:, 0] @ Kh @ u[:, 0]
                       + torch.sum(u[:, 1:] * (Kh @ Pinv_z)) / 4) / n
    surrogate.backward()
    for k in raw:
        assert out.grads[k] == pytest.approx(float(raw[k].grad), rel=1e-6, abs=1e-10)


def test_adam_matches_torch():
    p = {"a": 0.3, "b": -1.0}
    state = {}
    tp = torch.tensor([0.3, -1.0], dtype=torch.float64, requires_grad=True)
    opt = torch.optim.Adam([tp], lr=0.1)
    for g in ([0.5, -0.2], [0.1, 0.3], [-0.4, 0.0]):
        p, state = R.adam(p, {"a": g[0], "b": g[1]}, state, 0.1)
        tp.grad = torch.tensor(g, dtype=torch.float64)
        opt.step()
    assert [p["a"], p["b"]] == pytest.approx(tp.tolist(), rel=1e-12)


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-12, 3.0], dtype=torch.float32)
    r = R.round_tf32(x)
    assert r.tolist() == [1.0 + 2**-10, 1.0, 3.0]   # a tie rounds away, below half down
