"""The Eq. 2 backward's fused route (B5, `repro_torch.kernels.kgrad`) on the
CPU, where the kernel's plain version runs.

* The plain version, carried to the raw leaves by `ops.kgrad_grads`, gives
  the parameter gradients of the autograd loop (`partitioned.
  quad_form_partials`) and of the reference's `repro.core.partitioned.
  quad_form_partials` on the same numpy inputs, at fp64, for every kind the
  kernel takes, a sum of two components with their own lengthscales (the q
  ratios) and a product (the product rule).
* Routing: ARD, linear and fallback terms, more features or components
  than the kernel takes, and a caller that needs g_X each take the
  autograd loop; the
  registry's route counters and the engine's `eq2_backward` span count
  what ran, and both routes give the same gradients.
* The benchmark's reader `train.eq2_fused_share` on synthetic span records.

Tolerance: 1e-7 of the largest leaf gradient. Both sides compute in fp64;
what separates them is matern12 near the diagonal, where autograd
differentiates sqrt(d2) at d2's rounding error (d2 ~ 1e-16 from the norm
expansion) and the fused route's u phi'(u) = -sqrt(u) phi / 2 has no
division (the two differ by ~1e-9 there, ~1e-15 elsewhere).
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import init_kernel_params as ref_init_kp
from repro.core import parse_kernel as ref_parse
from repro.core.partitioned import quad_form_partials as ref_partials
from repro_torch import obs
from repro_torch.core import partitioned
from repro_torch.core.kernels_math import (
    init_kernel_params, params_leaves, params_unflatten)
from repro_torch.core.mll import (
    MLLConfig, eq2_route_counter, exact_mll, operator_mll_backward)
from repro_torch.core.operators import (
    OperatorConfig, backward_backend_for, make_operator)
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import kgrad, ops
from repro_torch.train.solver_state import WarmStartConfig, WarmStartEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-7
SPECS = ("rbf", "matern12", "matern32", "matern52", "rq", "wendland2",
         "wendland4", "0.5*rbf + matern32", "matern32 * wendland2")


def _params(spec, seed=0):
    """(reference params, port params) at the same perturbed fp64 values:
    every leaf moved off its init, so the components' lengthscales differ."""
    rng = np.random.default_rng(seed)
    p = ref_init_kp(ref_parse(spec), lengthscale=0.9,
                    radius=1.5 if "wendland" in spec else None,
                    dtype=jnp.float64)
    p = jax.tree.map(lambda a: np.asarray(a) + 0.3 * rng.standard_normal(np.shape(a)), p)
    return p, params_from_numpy(p, "cpu")


def _problem(n=70, d=3, t=5, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)), rng.normal(size=(n, t)),
            rng.normal(size=(n, t)))


def _close(got, want):
    scale = max(float(np.max(np.abs(np.asarray(w)))) for w in want)
    assert scale > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                   atol=TOL * scale)


@pytest.mark.parametrize("spec", SPECS)
def test_plain_matches_the_autograd_loop(spec):
    X, A, V = (torch.as_tensor(a) for a in _problem())
    _, p = _params(spec)
    assert ops.kgrad_pass_or_none(spec, p, X.shape[1]) is not None
    want, _, _ = partitioned.quad_form_partials(spec, X, X, A, V, p, row_block=32)
    got = ops.kgrad_grads(spec, X, A, V, p)
    _close(params_leaves(got), params_leaves(want))


@pytest.mark.parametrize("spec", SPECS)
def test_plain_matches_the_reference(spec):
    X, A, V = _problem(n=90, d=2, t=3, seed=2)
    p_ref, p = _params(spec, seed=3)
    want, _, _ = ref_partials(ref_parse(spec), jnp.asarray(X), jnp.asarray(X),
                              jnp.asarray(A), jnp.asarray(V), p_ref, row_block=32)
    got = ops.kgrad_grads(spec, *(torch.as_tensor(a) for a in (X, A, V)), p)
    _close(params_leaves(got), jax.tree.leaves(want))


def test_plain_sums_every_slot_and_the_two_totals():
    """[S0, S1, dq/ds] against sums over the dense slab, at fp64."""
    X, A, V = (torch.as_tensor(a) for a in _problem(n=40, d=2, t=3))
    comps = (("rq", "matern32"), ("wendland2",))
    w1, q1, al, q2, q3 = 0.7, 1.3, 2.5, 0.4, 0.05
    scal = torch.tensor([1.0, q1, al, q2, w1, q3], dtype=torch.float64)
    out = kgrad.kgrad_plain(comps, X, A, V, scal)
    d2 = torch.cdist(X, X) ** 2
    W = A @ V.T

    def k(q1_=q1, al_=al, q2_=q2, w1_=w1, q3_=q3, d2_=d2):
        rq = (1 + q1_ * d2_ / (2 * al_)) ** (-al_)
        a = np.sqrt(3) * torch.sqrt(q2_ * d2_)
        m32 = (1 + a) * torch.exp(-a)
        r = torch.sqrt(q3_ * d2_)
        w2 = torch.clamp(1 - r, min=0) ** 4 * (4 * r + 1)
        return rq * m32 + w1_ * w2

    h = 1e-6
    num = [float(torch.sum(W * (k(**{name: v + h}) - k(**{name: v - h}))) / (2 * h))
           for name, v in (("q1_", q1), ("al_", al), ("q2_", q2), ("w1_", w1),
                           ("q3_", q3))]
    assert float(out[0]) == pytest.approx(float(torch.sum(W * k())), rel=1e-12)
    s1 = float(torch.sum(W * (k(d2_=d2 * (1 + h)) - k(d2_=d2 * (1 - h)))) / (2 * h))
    assert float(out[1]) == pytest.approx(s1, rel=1e-6)
    got = [float(out[2 + i]) for i in (1, 2, 3, 4, 5)]
    np.testing.assert_allclose(got, num, rtol=1e-6)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

ROUTES = (  # (case, kernel, params kwargs, d, need_x, route)
    ("fused", "matern32", {}, 3, False, "fused"),
    ("sum", "0.5*rbf + matern32", {}, 3, False, "fused"),
    ("wants-g_X", "matern32", {}, 3, True, "autograd"),
    ("ard", "matern32", {"ard_dims": 3}, 3, False, "autograd"),
    ("linear", "linear + rbf", {}, 3, False, "autograd"),
    ("fallback", "linear * rbf", {}, 3, False, "autograd"),
    ("three-components", "rbf + matern32 + matern52", {}, 3, False, "autograd"),
    ("d17", "matern32", {}, 17, False, "autograd"),
)


@pytest.mark.parametrize("case", ROUTES, ids=lambda c: c[0])
def test_routes_and_their_gradients(case):
    _, kernel, kw, d, need_x, route = case
    rng = np.random.default_rng(4)
    X = torch.as_tensor(rng.normal(size=(50, d)))
    u_y, U, pinv_z = (torch.as_tensor(rng.normal(size=s))
                      for s in ((50,), (50, 4), (50, 4)))
    p = init_kernel_params(kernel, dtype=torch.float64, **kw)
    assert backward_backend_for("pallas") == "pallas"
    op = make_operator(OperatorConfig(kernel=kernel, backend="pallas"), X, p,
                       device="cpu")
    A, V = (torch.as_tensor(rng.normal(size=(50, 3))) for _ in range(2))
    assert op.routed_quad_form_grads(A, V, need_x)[2] == route
    counters = {r: eq2_route_counter(r) for r in ("fused", "autograd")}
    before = {r: c.value for r, c in counters.items()}
    cfg = MLLConfig(kernel=kernel, backend="pallas", row_block=32)
    g_X, _, g = operator_mll_backward(cfg, X, p, u_y, U, pinv_z, 0.7, need_x=need_x)
    assert {r: c.value - before[r] for r, c in counters.items()} == \
        {r: int(r == route) for r in counters}
    assert (g_X is None) == (route == "fused")
    ref = operator_mll_backward(cfg._replace(backend="partitioned"), X, p, u_y,
                                U, pinv_z, 0.7)
    _close(params_leaves(g), params_leaves(ref[2]))
    if g_X is not None:
        assert torch.equal(g_X, ref[0])


def test_exact_mll_routes_by_whether_X_needs_a_gradient():
    """`_ExactMLL.backward` asks for g_X only when X needs one (DKL's
    features do): fixed X takes the fused route, X with a gradient the
    autograd loop, and both give the same parameter gradients."""
    rng = np.random.default_rng(5)
    X = torch.as_tensor(rng.normal(size=(64, 2)))
    y = torch.as_tensor(rng.normal(size=64))
    p = init_kernel_params("matern32", noise=0.3, dtype=torch.float64)
    cfg = MLLConfig(kernel="matern32", backend="pallas", row_block=32,
                    precond_rank=8, num_probes=4, cg_tol=1e-10)
    fused = eq2_route_counter("fused")
    grads = {}
    for x_grad in (False, True):
        leaves = [a.clone().requires_grad_(True) for a in params_leaves(p)]
        before = fused.value
        value, _ = exact_mll(cfg, X.clone().requires_grad_(x_grad), y,
                             params_unflatten(p, leaves),
                             torch.Generator().manual_seed(7), device="cpu")
        value.backward()
        assert fused.value - before == int(not x_grad)
        grads[x_grad] = [a.grad for a in leaves]
    _close(grads[False], grads[True])


@pytest.mark.parametrize("kw,route", (({}, "fused"), ({"ard_dims": 2}, "autograd")),
                         ids=("shared", "ard"))
def test_engine_span_and_counter_name_the_route(kw, route, monkeypatch):
    """The pallas engine's `eq2_backward` spans carry the route its counter
    counted; its gradients equal those of the same engine held to the
    autograd loop."""
    rng = np.random.default_rng(6)
    X = torch.as_tensor(rng.normal(size=(64, 2)))
    y = torch.as_tensor(rng.normal(size=64))
    p = init_kernel_params("matern32", noise=0.3, dtype=torch.float64, **kw)
    cfg = MLLConfig(kernel="matern32", backend="pallas", row_block=32,
                    precond_rank=8, num_probes=4, cg_tol=1e-10)

    def run(want):
        eng = WarmStartEngine(cfg, WarmStartConfig(refresh_every=2))
        gen = torch.Generator().manual_seed(0)
        counter = eq2_route_counter(want)
        before = counter.value
        obs.drain_events()
        obs.enable_tracing(None)
        try:
            grads = [params_leaves(eng.step(X, y, p, gen)[2]) for _ in range(3)]
        finally:
            obs.disable_tracing(snapshot_metrics=False)
        spans = [e for e in obs.drain_events() if e.get("name") == "eq2_backward"]
        assert [e["args"]["route"] for e in spans] == [want] * 3
        assert counter.value - before == 3
        return grads

    got = run(route)
    monkeypatch.setattr(ops, "kgrad_pass_or_none", lambda *args: None)
    for a, b in zip(got, run("autograd")):
        _close(a, b)


# ---------------------------------------------------------------------------
# the benchmark's reader
# ---------------------------------------------------------------------------


def _reader():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from gpbench.harness import manifest

    return manifest.load_reader("train.eq2_fused_share", os.path.join(ROOT, "gpbench"))


def _span(name, **args):
    return {"name": name, "ph": "X", "args": {"measured_ms": 1.0, **args}}


@pytest.mark.parametrize("spans,want", (
    ([_span("eq2_backward", route="fused")] * 3, 100.0),
    ([_span("eq2_backward", route="fused"), _span("eq2_backward", route="autograd"),
      _span("cg_solve"), _span("eq2_backward", route="fused"),
      _span("eq2_backward", route="autograd")], 50.0),
    ([_span("eq2_backward", route="autograd")], 0.0),
    ([_span("eq2_backward"), _span("cg_solve")], None),   # the parent's spans
    ([], None),
), ids=("all-fused", "half", "none-fused", "no-route", "no-spans"))
def test_fused_share_reader(spans, want):
    got = _reader()({"spans": spans, "steps": 3})
    assert got == want
