"""A run's check against a timed path broken underneath: the harness's
look for a card skipped, a cell driven on the CPU at a small size, and
`correct` has to come out false for every fault the cell can have (and
true for the sound program)."""

from __future__ import annotations

import contextlib
import time

import pytest
import torch


@contextlib.contextmanager
def _patch(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def state_unchanged():
    """The optimizer hands the hyperparameters back unmoved."""
    from repro_torch.train import gp_trainer

    return _patch(gp_trainer, "adam_update", lambda params, grads, state, lr: (params, state))


def half_rows():
    """Every step sees the first half of the rows, the mean taken over them."""
    from repro_torch.train.solver_state import WarmStartEngine

    step = WarmStartEngine.step

    def half(self, X, y, params, generator=None, **kw):
        h = X.shape[0] // 2
        return step(self, X[:h], y[:h], params, generator, **kw)

    return _patch(WarmStartEngine, "step", half)


def altered_gradient():
    """The gradient a step hands the optimizer, altered where it is made."""
    from repro_torch.core.kernels_math import params_leaves, params_unflatten
    from repro_torch.train.solver_state import WarmStartEngine

    step = WarmStartEngine.step

    def altered(self, *a, **kw):
        loss, aux, g = step(self, *a, **kw)
        leaves = params_leaves(g)
        return loss, aux, params_unflatten(g, [leaves[0] * 1.5] + leaves[1:])

    return _patch(WarmStartEngine, "step", altered)


@contextlib.contextmanager
def altered_after_setup():
    """The gradient altered from the second call on: set-up's call is
    sound, the window's are not (state carried from call to call)."""
    from repro_torch.core.kernels_math import params_leaves, params_unflatten
    from repro_torch.train.solver_state import WarmStartEngine

    init, step = WarmStartEngine.__init__, WarmStartEngine.step
    engines = []

    def counted(self, *a, **kw):
        init(self, *a, **kw)
        engines.append(self)

    def altered(self, *a, **kw):
        loss, aux, g = step(self, *a, **kw)
        if self is engines[0]:
            return loss, aux, g
        leaves = params_leaves(g)
        return loss, aux, params_unflatten(g, [leaves[0] * 1.5] + leaves[1:])

    with _patch(WarmStartEngine, "__init__", counted), _patch(WarmStartEngine, "step", altered):
        yield


def altered_answer():
    """The means of each engine call's first and last query altered where
    the engine produces them. In the test's mix a batch holds at most two
    requests (64 rows each, max_batch 128), so every request answered has
    an altered row and the check's sample cannot miss them all."""
    from repro_torch.serve.engine import PredictionEngine

    predict = PredictionEngine.predict

    def altered(self, Xstar):
        mean, var = predict(self, Xstar)
        mean = mean.clone()
        mean[[0, -1]] += 5e-2 * (1.0 + mean.abs().max())
        return mean, var

    return _patch(PredictionEngine, "predict", altered)


def half_batch():
    """Only the first half of each batch's rows answered; the rest repeat it."""
    from repro_torch.serve.engine import PredictionEngine

    predict = PredictionEngine.predict

    def half(self, Xstar):
        Xstar = torch.as_tensor(Xstar)
        h = max(1, Xstar.shape[0] // 2)
        mean, var = predict(self, Xstar[:h])
        reps = -(-Xstar.shape[0] // h)
        return mean.repeat(reps)[:Xstar.shape[0]], var.repeat(reps)[:Xstar.shape[0]]

    return _patch(PredictionEngine, "predict", half)


FAULTS = {"he-train": [None, state_unchanged, half_rows, altered_gradient,
                       altered_after_setup],
          "he-serve": [None, altered_answer, half_batch],
          "taper-serve": [None, altered_answer, half_batch]}
CASES = [(cell, f) for cell, fs in FAULTS.items() for f in fs]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__ if f else 'sound'}" for c, f in CASES])
def test_fault_makes_the_run_incorrect(cell, fault, small_cell, capsys):
    from gpbench.run import run_cell

    torch.set_num_threads(2)
    c, overrides = small_cell(cell)
    line = run_cell(c, seed=2**31 + 101, seconds=0.3, trace=False, device="cpu",
                    t_start=time.perf_counter(), overrides=overrides, fault=fault)
    assert line["correct"] is (fault is None), line["checks"]
    err = capsys.readouterr().err.strip().splitlines()
    assert all(ln.startswith("check ") for ln in err[-len(line["checks"]):])
