"""Driver "finetune": the paper's full-data fine-tuning stage, repeated.

Each call is `fit_exact_gp(method="adam")` from the configuration's
hyperparameters: a new warm-start engine and `adam_steps` Adam steps (cold,
then warm or refresh). Starting every call from the same point keeps the
work of a step the same however many steps a faster program fits in the
window; the probe generator runs on from call to call.

Set-up makes the first call; the window repeats it until `seconds` have
passed at the end of a call. Throughout, the program's engine is subclassed
to record each step's incoming hyperparameters, loss, gradient (as the
optimizer gets it) and carried state (the preconditioner's factor, the
probes, the solutions) with its telemetry; only references are kept, those
of set-up's call and of the latest call, so the check judges set-up's call
and the window's last one.

The check (`judge`) follows each of the two recorded calls step by step from
its own state, in float64: the solutions each step's CG carried on are held
against the residuals its recurrence claimed, each step's gradient against
Eq. 2 from those solutions and the step's probes and preconditioner, each
loss against its quadratic term and its log-determinant, each fresh
log-determinant estimate against the exact one, the preconditioner's factor
against K on its pivot rows, and the change after the call against Adam's
from the program's gradients. The program's own iterates are what is
judged: an unconverged CG iterate (the paper's tolerance 1.0 stops after
some ten iterations) moves by percents under fp32 rounding, so a replay of
the iterations in float64 cannot be held to them.
"""

from __future__ import annotations

import contextlib
import math
import os
import statistics

from gpbench import data
from gpbench.harness import program
from gpbench.harness import trace as tracing
from gpbench.harness.output import Check
from gpbench.harness.window import Outcome, free, now, peak_bytes, reset_peak, sync
from gpbench.reference import FP64, TF32, Operator, Precond, adam, bbmm_step, \
    eq2_grads, exact_logdet, pivoted_cholesky, precond_gap

LIMITS = "train"   # the configuration's group of limits this driver's checks use


@contextlib.contextmanager
def recording(trainer_mod, log: list):
    """Record every engine step of `trainer_mod.fit_exact_gp` into the last
    list of `log` (a call appends its own; see `run`)."""
    Engine = trainer_mod.WarmStartEngine

    class Recording(Engine):
        def step(self, X, y, params, generator=None, **kw):
            out = super().step(X, y, params, generator, **kw)
            log[-1].append({"params": params, "loss": out[0], "aux": out[1],
                            "grads": out[2], "state": self.state,
                            "telemetry": dict(self.telemetry[-1])})
            return out

    trainer_mod.WarmStartEngine = Recording
    try:
        yield
    finally:
        trainer_mod.WarmStartEngine = Engine


def run(ctx) -> Outcome:
    import torch
    from repro_torch import obs
    from repro_torch.train import gp_trainer

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    g = cfg["gp"]
    draw = data.permuted(data.make(cfg, dev), ctx.seed)
    X, y = draw.X, draw.y
    reset_peak(dev)
    raw0 = program.raw_leaves(cfg)
    gp = program.gp_model(cfg, dev)
    params0 = program.program_params(cfg, raw0, dev)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed % (2 ** 63))
    tcfg = gp_trainer.GPTrainConfig(
        plain_adam_steps=tr["adam_steps"], plain_adam_lr=tr["lr"],
        warm_start=g["warm_start"], refresh_every=g["refresh_every"],
        drift_threshold=g["drift_threshold"])

    log: list = []   # the steps of set-up's call and of the latest call

    def call():
        log.append([])
        if len(log) > 2:
            del log[1]
        res = gp_trainer.fit_exact_gp(gp, X, y, method="adam", cfg=tcfg,
                                      params0=params0, generator=gen, device=dev)
        sync(dev)
        return res

    fault = ctx.fault() if ctx.fault else contextlib.nullcontext()
    with fault, recording(gp_trainer, log):
        first = call()
        setup_s = now() - ctx.t_start

        telemetry, spans = [], []
        if ctx.trace:
            obs.enable_tracing(None)
        before = program.launches()
        steps = calls = 0
        with tracing.Session(ctx.trace, os.path.join(ctx.run_dir, "trace.json")) as ts:
            t0 = now()
            while True:
                res = call()
                steps += len(res.loss_trace)
                calls += 1
                telemetry.extend(res.telemetry)
                if now() - t0 >= ctx.seconds:
                    break
            t1 = now()
        launched = program.since(before)
        if ctx.trace:
            spans = obs.drain_events()
            obs.disable_tracing(snapshot_metrics=False)
    peak = peak_bytes(dev)
    n, d = X.shape
    records = {"steps": steps, "calls": calls, "window_s": t1 - t0,
               "telemetry": telemetry, "spans": spans, "launches": launched,
               "profile": ts.result, "shape": {"n": n, "d": d,
                                               "t": 1 + g["num_probes"]},
               "factors": cfg["factors"], "precond_rank": g["precond_rank"],
               "leaves": len(cfg["leaves"]) - 1}
    e2e = {"setup_s": setup_s, "train_step_s": (t1 - t0) / steps}
    runs = [program_run(cfg, log[0], program.raw_of(cfg, first.params)),
            program_run(cfg, log[-1], program.raw_of(cfg, res.params))]
    del gp, params0, first, res, gen, log
    free(dev)
    if ctx.capture is not None:
        ctx.capture.update(cfg=cfg, tr=tr, X=X, y=y, raw0=raw0, runs=runs)
    checks = training_checks(cfg, tr, X, y, raw0, runs, cfg["limits"][LIMITS])
    return Outcome(steps, 0, e2e, records, checks, peak)


def program_run(cfg, log, final) -> dict:
    """The recorded call as plain data: per step the hyperparameters it
    started from, its mode and per-column iteration counts, the
    preconditioner's factor, the probes and solutions it carried on, its
    residuals as the CG recurrence measured them, its loss and
    log-determinant, and the gradient the optimizer got; then the final raw
    leaves."""
    from repro_torch.core.kernels_math import params_leaves

    steps = []
    for rec in log:
        st, aux = rec["state"], rec["aux"]
        steps.append({"raw": program.raw_of(cfg, rec["params"]),
                      "mode": rec["telemetry"]["mode"],
                      "iters": rec["telemetry"]["cg_iters_per_rhs"],
                      "L": st.precond.L.detach(), "probes": st.solve.probes.detach(),
                      "solutions": st.solve.solutions.detach(),
                      "rel": [float(v) for v in aux.rel_residual],
                      "loss": float(rec["loss"]), "logdet": float(aux.logdet),
                      "grads": {k: float(v) for k, v in
                                zip(cfg["leaves"], params_leaves(rec["grads"]))}})
    return {"steps": steps, "final": final}


def _leaf_gaps(a: dict, b: dict) -> list:
    """Per leaf: | |a| - |b| | over max(|b|, the median leaf's |b|), over the
    leaves whose |b| is at least a thousandth of the median leaf's (the
    others move by round-off alone)."""
    med = statistics.median(abs(v) for v in b.values())
    keep = [k for k, v in b.items() if abs(v) >= 1e-3 * med]
    return [abs(abs(a[k]) - abs(b[k])) / max(abs(b[k]), med) for k in keep]


def judge(cfg, tr, X, y, raw0, run_, *, logdets: bool = True) -> dict:
    """The numbers of a run (the program's, or a stand-in's in its place),
    judged in float64 from its own state step by step:

    `cg_gap`: how far each column's residual as the run's CG recurrence
    claims it lies from the true one of the solutions it carried on;
    `cg_residual`: the largest claimed residual of a column that stopped
    before the iteration cap (the configuration's tolerance is its limit);
    `grad_gap`: each step's gradient against Eq. 2 from the run's own
    solutions, probes and preconditioner, by leaf (| |run| - |ref| | over
    max(|ref|, the median leaf's)); `loss_gap`: each step's loss against
    the quadratic term of its solution and its log-determinant;
    `logdet_gap`: each cold or refresh step's log-determinant estimate
    against the exact one, per datum over 2 (the loss's units);
    `precond_gap`: the preconditioner's factor against K on its pivot rows;
    `change_gap`: the change of the leaves after the call against Adam's
    from the run's own gradients, by leaf."""
    import torch

    g = cfg["gp"]
    n = X.shape[0]
    const = n * math.log(2.0 * math.pi)
    out = dict.fromkeys(("cg_gap", "cg_residual", "grad_gap", "loss_gap",
                         "logdet_gap", "precond_gap"), 0.0)
    raw, state = dict(raw0), {}
    P = None
    for st in run_["steps"]:
        op = Operator(program.ref_kernel(cfg, st["raw"]), X, FP64)
        if st["mode"] != "warm":
            # built at this step's noise; a warm step reuses it as it is
            L = _rows(st["L"], n)
            P = Precond(L, op.kern.noise, FP64)
            out["precond_gap"] = max(out["precond_gap"], precond_gap(op, L))
        sol, probes = _rows(st["solutions"], n), _rows(st["probes"], n)
        yc = y.double() - op.kern.mean
        B = torch.cat([yc[:, None], probes.double()], 1)
        R = B - op.matvec(sol.double())
        rel_true = (R.norm(dim=0) / B.norm(dim=0)).tolist()
        out["cg_gap"] = max([out["cg_gap"]] + [abs(a - b) for a, b in zip(rel_true, st["rel"])])
        early = [r for r, it in zip(st["rel"], st["iters"]) if it < g["train_max_cg_iters"]]
        out["cg_residual"] = max([out["cg_residual"]] + early)
        ref_g = eq2_grads(op, P, sol, probes)
        out["grad_gap"] = max([out["grad_gap"]] + _leaf_gaps(st["grads"], ref_g))
        quad = float(yc @ sol[:, 0].double())
        out["loss_gap"] = max(out["loss_gap"],
                              abs(st["loss"] - 0.5 * (quad + st["logdet"] + const) / n))
        if logdets and st["mode"] != "warm":
            ld = exact_logdet(op)
            out["logdet_gap"] = max(out["logdet_gap"], abs(st["logdet"] - ld) / (2 * n))
        raw, state = adam(raw, st["grads"], state, tr["lr"])
        del op
        free(X.device)
    ch_run = {k: run_["final"][k] - raw0[k] for k in raw0}
    ch_ref = {k: raw[k] - raw0[k] for k in raw0}
    out["change_gap"] = max(_leaf_gaps(ch_run, ch_ref))
    return out


def _rows(a, n: int):
    """`a` with zero rows appended up to n (a stand-in that saw fewer rows)."""
    import torch

    if a.shape[0] == n:
        return a
    pad = torch.zeros((n - a.shape[0],) + tuple(a.shape[1:]), dtype=a.dtype,
                      device=a.device)
    return torch.cat([a, pad])


def judge_calls(cfg, tr, X, y, raw0, runs) -> dict:
    """Every number of `judge` over the recorded calls: the worst call's."""
    nums = [judge(cfg, tr, X, y, raw0, r) for r in runs]
    return {k: max(n[k] for n in nums) for k in nums[0]}


def training_checks(cfg, tr, X, y, raw0, runs, limits) -> list:
    """Judge the program's recorded calls in float64."""
    nums = judge_calls(cfg, tr, X, y, raw0, runs)
    return [Check(k, nums[k], limit) for k, limit in limits.items()]


def replay(cfg, tr, X, y, raw0, steps, prec) -> dict:
    """A stand-in in the program's place: the recorded steps computed again
    at precision `prec` (the reference's own mBCG, SLQ, Eq. 2 and Adam) from
    raw0, with each step's probes, preconditioner factor and iteration
    counts, as a run of the same form as `program_run`'s."""
    raw, state = dict(raw0), {}
    out, sol, carry, P = [], None, None, None
    for st in steps:
        op = Operator(program.ref_kernel(cfg, raw), X, prec)
        mode = st["mode"]
        if mode != "warm":
            P = Precond(st["L"], op.kern.noise, prec)
        if mode == "cold":
            x0 = None
        elif mode == "warm":
            x0 = sol
        else:
            x0 = sol.clone()
            x0[:, 1:] = 0.0
        r = bbmm_step(op, y, P, st["probes"], st["iters"], x0=x0,
                      logdet_carry=carry if mode == "warm" else None)
        carry = r.logdet
        sol = r.solutions
        out.append(dict(st, raw=dict(raw), solutions=r.solutions, rel=r.rel,
                        loss=r.loss, logdet=r.logdet, grads=r.grads))
        raw, state = adam(raw, r.grads, state, tr["lr"])
        del op
        free(X.device)
    return {"steps": out, "final": raw}


def controls(cap: dict, full: bool = True) -> dict:
    """`program`: every number of the captured run (both recorded calls);
    with `full`, the stand-ins' readings too (`stand_ins`, on set-up's
    call)."""
    cfg, tr, X, y, raw0, runs = (cap[k] for k in ("cfg", "tr", "X", "y", "raw0", "runs"))
    out = {"program": judge_calls(cfg, tr, X, y, raw0, runs)}
    if full:
        out.update(stand_ins(cfg, tr, X, y, raw0, runs[0]))
    return out


def stand_ins(cfg, tr, X, y, raw0, run_) -> dict:
    """Readings of the numbers when a stand-in takes the program's place,
    each judged as the program is: `tf32`, the reference at TF32 (its
    `precond_gap` from a factor it builds itself at TF32); `half`, the
    reference on the first half of the rows (the mean taken over them);
    `altered`, the program's run with its first gradient's largest leaf
    doubled. A state left unchanged reads 1 on `change_gap` by its
    definition and needs no run."""
    steps = run_["steps"]
    out = {"tf32": judge(cfg, tr, X, y, raw0, replay(cfg, tr, X, y, raw0, steps, TF32))}
    op = Operator(program.ref_kernel(cfg, steps[0]["raw"]), X, TF32)
    L = pivoted_cholesky(op, cfg["gp"]["precond_rank"])
    del op
    op = Operator(program.ref_kernel(cfg, steps[0]["raw"]), X, FP64, dense_limit=0)
    out["tf32"]["precond_gap"] = precond_gap(op, L)
    h = X.shape[0] // 2
    half_steps = [dict(st, L=st["L"][:h], probes=st["probes"][:h]) for st in steps]
    out["half"] = judge(cfg, tr, X, y, raw0, replay(cfg, tr, X[:h], y[:h], raw0, half_steps, FP64))
    big = max(steps[0]["grads"], key=lambda k: abs(steps[0]["grads"][k]))
    alt = [dict(steps[0], grads={**steps[0]["grads"], big: 2.0 * steps[0]["grads"][big]})]
    out["altered"] = judge(cfg, tr, X, y, raw0, dict(run_, steps=alt + steps[1:]),
                           logdets=False)
    return out
