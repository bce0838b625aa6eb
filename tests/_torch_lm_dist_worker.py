"""Rank programs of the multi-rank LM training tests (gloo on the CPU).

Run through `_torch_dist_worker.spawn("_torch_lm_dist_worker:<name>", ...)`:
each rank has joined its gloo group when the function runs, and what it
returns is saved for the parent (tests/test_torch_lm_dist.py), which holds
it against the JAX reference. This module imports torch and repro_torch
only, so the ranks never load JAX.
"""

from __future__ import annotations

import contextlib
import io
import os
import signal
import time

import numpy as np
import torch
import torch.distributed as dist


def _np(t) -> np.ndarray:
    """A tensor's full value as numpy; bf16 as its uint16 bits."""
    from repro_torch.train.checkpoint import to_numpy

    return to_numpy(t)


def _full_state(state) -> dict:
    """{'params' | 'mu' | 'nu': {name: full array}, 'step': int} (a gather
    on every rank for a sharded state)."""
    return {"params": {k: _np(v) for k, v in state.params.items()},
            "mu": {k: _np(v) for k, v in state.mu.items()},
            "nu": {k: _np(v) for k, v in state.nu.items()},
            "step": int(_np(state.step))}


def _metrics(met) -> dict:
    return {k: float(_np(v)) for k, v in met.items()}


def train_steps(rank, p):
    """One fp32 `make_train_step` step per case of this world's size, on a
    (data, model) host mesh: the reference's weights placed by
    `place_train_state`, the global batch sharded over the data axes.
    Returns per case the metrics (this rank's view), the gathered new
    state, the ops that ran replicated and the placements of the state."""
    from repro_torch.interop import lm_params_from_numpy
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_arch
    from repro_torch.models.sharding import batch_pspec
    from repro_torch.train.elastic import reshard

    out = {}
    for case in p["cases"]:
        arch, shape = case["arch"], case["mesh"]
        cfg = get_arch(arch).reduced()
        mesh = make_host_mesh(*shape, device="cpu")
        lm = lm_params_from_numpy(cfg, p["params"][arch], "cpu")
        params = {k: v.detach() for k, v in lm.named_parameters()}
        mu = {k: torch.zeros_like(v) for k, v in params.items()}
        state = steps.TrainState(params, mu, {k: v.clone() for k, v in mu.items()},
                                 torch.zeros((), dtype=torch.int32))
        state = steps.place_train_state(mesh, state)
        batch = reshard({k: torch.as_tensor(v) for k, v in p["batch"].items()},
                        mesh, lambda path, leaf: batch_pspec(mesh))
        step = steps.make_train_step(cfg, mesh, lr=p["lr"])
        new, met = step(state, batch)
        out[(arch, tuple(shape))] = got = {
            "metrics": _metrics(met), "state": _full_state(new),
            "fallbacks": dict(step.fallbacks),
            "placements": {k: [str(pl) for pl in v.placements]
                           for k, v in new.params.items()},
            "step_placements": [str(pl) for pl in new.step.placements],
            "local_rows": batch["tokens"].to_local().shape[0]}
        if case.get("microbatch"):
            mb = steps.make_train_step(cfg, mesh, lr=p["lr"],
                                       microbatch=case["microbatch"])
            new, met = mb(state, batch)
            got["microbatch"] = {"metrics": _metrics(met),
                                 "state": _full_state(new)}
    return out


def stream(rank, p):
    """This rank's batches of `TokenPipeline` on a (data, model) mesh, and
    the error a global batch the data axes do not divide raises."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(*p["mesh"], device="cpu")
    pipe = TokenPipeline(mesh, p["vocab"], p["batch"], p["seq"], seed=0)
    try:
        got = [next(pipe) for _ in range(p["n"])]
    finally:
        pipe.close()
    try:
        TokenPipeline(mesh, p["vocab"], p["batch"] + 1, p["seq"], seed=0).close()
        err = ""
    except ValueError as e:
        err = str(e)
    return {"tokens": [b.tokens.to_local().numpy() for b in got],
            "targets": [b.targets.to_local().numpy() for b in got],
            "global_shape": tuple(got[0].tokens.shape),
            "placements": [str(pl) for pl in got[0].tokens.placements],
            "coords": mesh.coords, "error": err}


def _count_writes():
    """Count this rank's checkpoint file writes (`checkpoint._write`)."""
    from repro_torch.train import checkpoint

    calls = []
    inner = checkpoint._write

    def spy(final, step, arrays, meta):
        calls.append(step)
        return inner(final, step, arrays, meta)

    checkpoint._write = spy
    return calls, lambda: setattr(checkpoint, "_write", inner)


def launch(rank, p):
    """`launch.train.main` once per entry of `p["runs"]` (argv plus an
    optional hook), in order: each run's stdout, report, the full state
    its first step was given (a resume's restored state) and the steps
    whose checkpoint this rank wrote. Hooks: "sigterm" sends SIGTERM to
    rank 1 during the second step; "nan" makes the second step's loss NaN
    on rank 0 only."""
    from repro_torch.launch import train

    outs = []
    for run in p["runs"]:
        hook = run.get("hook")
        given = []   # the state each call of the step was given

        def wrap(step_fn, hook=hook, given=given):
            def wrapped(state, batch):
                given.append(state)
                if hook == "sigterm" and len(given) == 2 and rank == 1:
                    os.kill(os.getpid(), signal.SIGTERM)
                new, met = step_fn(state, batch)
                if hook == "nan" and len(given) == 2 and rank == 0:
                    met = dict(met, loss=met["loss"] * float("nan"))
                return new, met
            return wrapped

        writes, undo = _count_writes()
        text = io.StringIO()
        try:
            with contextlib.redirect_stdout(text):
                report = train.main(run["argv"], wrap_step=wrap)
        finally:
            undo()
        outs.append({
            "stdout": text.getvalue(), "losses": report["losses"],
            "steps_run": report["steps_run"], "skipped": report["skipped"],
            "mesh": report["mesh"], "fallbacks": report["fallbacks"],
            "first_state": _full_state(given[0]), "writes": list(writes),
            "final": _full_state(report["state"]),
            # the call after a skipped step got the very state it got
            "same_after_skip": len(given) > 2 and given[2] is given[1]})
    return outs


def timeout(rank, p):
    """`run_train_loop` with a watchdog where only rank 1 is slow at the
    second call: both ranks skip that step."""
    from repro_torch.train.trainer import TrainLoopConfig, run_train_loop

    calls = []

    def step_fn(state, batch):
        calls.append(1)
        if rank == 1 and len(calls) == 2:
            time.sleep(p["sleep"])
        w = state["w"] - 0.1 * (state["w"] - batch)
        return {"w": w}, {"loss": torch.sum((w - batch) ** 2)}

    def batches():
        i = 0
        while True:
            yield torch.ones(4) * (i % 3)
            i += 1

    lines = []
    res = run_train_loop(step_fn, {"w": torch.zeros(4)}, batches(),
                         TrainLoopConfig(total_steps=3, log_every=100,
                                         step_timeout_s=p["timeout"]),
                         log_fn=lines.append)
    return {"steps_run": res.steps_run, "skipped": res.skipped,
            "calls": len(calls), "w": res.state["w"].numpy(), "lines": lines,
            "world": dist.get_world_size()}


def several(rank, p):
    """{name: this module's function `name` on p[name]}, in order: several
    rank programs in one spawned world."""
    return {name: globals()[name](rank, sub) for name, sub in p.items()}
