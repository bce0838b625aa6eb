"""Driver "dkl_finetune": deep kernel learning, an LM backbone under the
exact GP, fine-tuned by repeated calls of a few Adam steps.

Each call is `fit_dkl` from the set-up state: the backbone's weights are
copied back from a copy made in set-up, the GP head starts from the
configuration's hyperparameters and Adam from zero moments, so the work of
a step stays the same however many steps fit in the window; the probe
generator runs on from call to call. Set-up makes the first call; the
window repeats it until `seconds` have passed at the end of a call. The
program's step (`gp_trainer._dkl_step`) and its MLL forward
(`core.mll.operator_mll_forward`) are wrapped to record, for set-up's call
and the latest one, each step's features, its feature gradient g_X, the
GP head's state (preconditioner factor, probes, solutions, residuals,
loss, log-determinant, gradient), at a call's first step the gradients of
the configuration's `grad_leaves`, and at every step their gradients at a
sample of `change_sample` elements a leaf drawn by the seed, whose values
are read again at the end of each call.

The check, against the plain references (`reference/backbones/<arch
family>.py` for the backbone, float32 and TF32 off; `gpbench.reference` for
the GP, float64):

* `features_gap`: the features the latest call's first step fed the GP
  head (the window's own, from `fit_dkl`'s micro-batched pass at the set-up
  weights), at `check_sequences` training sequences drawn by the seed,
  against the reference's (its Mamba-2 by the recurrence), relative to
  their norm;
* he-train's judge (`drivers/finetune.py: judge`, unchanged) on each
  recorded step, on that step's own features: `cg_gap`, `cg_residual`,
  `grad_gap`, `loss_gap`, `logdet_gap`, `precond_gap`; `change_gap` over
  each whole call, Adam's chain from the recorded gradients (`reference.adam`)
  against the head's final hyperparameters, by the judge's measure;
* `x_grad_gap`: each recorded g_X against Eq. 2's X gradient from the
  step's solutions, probes and factor (the backbone reference's
  `matern32_x_grad`, float64), relative to its norm;
* `backbone_grad_gap`: the reference's VJP of the pooled features of all
  training sequences with the latest call's first g_X (fp32, in blocks of
  `vjp_block` sequences) against the program's gradient of each of
  `grad_leaves` at that step, relative to the leaf's norm, the worst leaf;
* `backbone_change_gap`: over each recorded call, the change of each of
  `grad_leaves` at its sampled elements against Adam's (the judge's
  constants) chained in float64 over the program's own gradients from the
  set-up values, each new value kept in the leaf's dtype as the program
  keeps it, relative to the change's norm, the worst leaf (a backbone that
  Adam leaves unchanged reads 1);
* `moe_dropped`: the program's `moe.dropped` counter over the run (0).

The judge's `logdet_gap` is computed and kept beside the others for the
controls, but is not a limit here: no stand-in reads it 10x past the
program (PERF.md, section 2).
"""

from __future__ import annotations

import contextlib
import os

from gpbench import data
from gpbench.harness import manifest, program
from gpbench.harness import trace as tracing
from gpbench.harness.output import Check
from gpbench.harness.window import Outcome, free, now, peak_bytes, reset_peak, sync
from gpbench.reference import FP64, Precond, adam

LIMITS = "dkl"     # the configuration's group of limits this driver's checks use
SOLVE = ("cg_gap", "cg_residual", "grad_gap", "loss_gap", "logdet_gap", "precond_gap")


def backbone_reference(cfg: dict):
    """The plain reference module of the configuration's backbone."""
    return manifest.load_part("reference/backbones", cfg["model_type"], cfg["bench"])


def program_arch(cfg: dict):
    """The program's config of the configuration's architecture, cut as the
    file says; raises where a width differs from the file's."""
    from repro_torch.models import get_arch

    arch = get_arch(cfg["arch"])._replace(
        n_layers=cfg["num_hidden_layers"], expert_offset=cfg["expert_offset"],
        experts_held=cfg["num_local_experts"])
    mine = (arch.d_model, arch.n_heads, arch.n_kv_heads, arch.d_ff, arch.d_shared,
            arch.vocab, arch.n_experts, arch.top_k, arch.ssm_state, arch.ssm_heads,
            arch.residual_multiplier, arch.embedding_multiplier,
            arch.attention_multiplier, arch.norm_eps,
            list(arch.layer_types[:arch.n_layers]))
    theirs = (cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"],
              cfg["intermediate_size"], cfg["shared_intermediate_size"], cfg["vocab_size"],
              cfg["router_experts"], cfg["num_experts_per_tok"], cfg["mamba_d_state"],
              cfg["mamba_n_heads"], cfg["residual_multiplier"], cfg["embedding_multiplier"],
              cfg["attention_multiplier"], cfg["rms_norm_eps"], cfg["layer_types"])
    if mine != theirs:
        raise ValueError(f"the program's {cfg['arch']} differs from the configuration: "
                         f"{mine} != {theirs}")
    return arch


@contextlib.contextmanager
def recording(gp_trainer, mll_mod, cfg: dict, log: list, leaf_index: dict, sample: dict):
    """Record every DKL step into the last list of `log` (see the module)."""
    step_fn, forward = gp_trainer._dkl_step, mll_mod.operator_mll_forward
    head: dict = {}

    def forward_rec(op, y, generator=None, **kw):
        if kw.get("precond") is None:
            kw["precond"] = op.preconditioner(kw["precond_rank"])
        out = forward(op, y, generator, **kw)
        head.update(L=kw["precond"].L.detach(), state=out[2])
        return out

    def step_rec(model, tokens, y, phi, leaves, gp_params, generator, microbatch):
        out = step_fn(model, tokens, y, phi, leaves, gp_params, generator, microbatch)
        loss, aux, feats, g_X, g_phi, g_gp = out
        from repro_torch.core.kernels_math import params_leaves

        rec = {"raw": program.raw_of(cfg, gp_params), "mode": "cold",
               "iters": [int(v) for v in aux.cg_iterations],
               "rel": [float(v) for v in aux.rel_residual],
               "loss": float(loss), "logdet": float(aux.logdet),
               "grads": {k: float(v) for k, v in zip(cfg["leaves"], params_leaves(g_gp))},
               "L": head["L"], "probes": head["state"].probes.detach(),
               "solutions": head["state"].solutions.detach(),
               "feats": feats, "g_X": g_X.detach()}
        if not log[-1]:
            rec["leaf_grads"] = {k: g_phi[i].detach().clone() for k, i in leaf_index.items()}
        rec["sampled_grads"] = {k: g_phi[i].detach().reshape(-1)[sample[k]].double()
                                for k, i in leaf_index.items()}
        log[-1].append(rec)
        return out

    gp_trainer._dkl_step, mll_mod.operator_mll_forward = step_rec, forward_rec
    try:
        yield
    finally:
        gp_trainer._dkl_step, mll_mod.operator_mll_forward = step_fn, forward


def sample_elements(lm, leaves, count: int, seed: int) -> dict:
    """Leaf name -> `count` element indices drawn by the seed (every
    element of a smaller leaf), on the leaf's device."""
    import torch

    g = data.generator(seed, "cpu")
    params = dict(lm.named_parameters())
    out = {}
    for k in leaves:
        p = params[k]
        idx = (torch.arange(p.numel()) if p.numel() <= count
               else torch.randint(0, p.numel(), (count,), generator=g).sort().values)
        out[k] = idx.to(p.device)
    return out


def _counter(name: str) -> int:
    from repro_torch import obs

    return int(obs.counter(name).value)


def span_ms() -> dict:
    """Span name -> total ms of the program's span totals (the last traced
    window's)."""
    from repro_torch import obs

    return {k[len("span."):]: v["total_ms"] for k, v in obs.registry().snapshot().items()
            if k.startswith("span.") and isinstance(v, dict) and "total_ms" in v}


def run(ctx) -> Outcome:
    import functools

    import torch
    import repro_torch.core.mll as mll_mod
    from repro_torch import obs
    from repro_torch.core.dkl import DKLModel, pooled_features
    from repro_torch.models import init_params
    from repro_torch.train import gp_trainer

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    arch = program_arch(cfg)                # a program without the family stops here
    dk, g = cfg["dkl"], cfg["gp"]
    draw = data.permuted(data.make(cfg, dev), ctx.seed)
    X, y = draw.X, draw.y
    dropped0 = _counter("moe.dropped")
    reset_peak(dev)
    lm = init_params(arch, torch.Generator(device=dev).manual_seed(cfg["weight_seed"]),
                     dtype=torch.bfloat16, device=dev)
    names = [k for k, _ in lm.named_parameters()]
    leaf_index = {k: names.index(k) for k in dk["grad_leaves"]}
    sample = sample_elements(lm, dk["grad_leaves"], dk["change_sample"], ctx.seed)
    params = list(lm.parameters())
    snapshot = [p.detach().clone() for p in params]
    start = {k: snapshot[i].reshape(-1)[sample[k]].double() for k, i in leaf_index.items()}
    dtypes = {k: params[i].dtype for k, i in leaf_index.items()}
    raw0 = program.raw_leaves(cfg)
    gp = program.gp_model(cfg, dev)
    params0 = program.program_params(cfg, raw0, dev)
    model = DKLModel(gp, functools.partial(pooled_features, arch, device=dev))
    dcfg = gp_trainer.DKLTrainConfig(adam_steps=tr["adam_steps"], lr=tr["lr"],
                                     microbatch=dk["microbatch"])
    gen = torch.Generator(device=dev).manual_seed(ctx.seed % (2 ** 63))
    log: list = []    # the steps of set-up's call and of the latest call
    ends: list = []   # the sampled elements' values at the end of each of those calls

    def call():
        with torch.no_grad():
            for p, s in zip(params, snapshot):
                p.data.copy_(s)
        log.append([])
        if len(log) > 2:
            del log[1]
        res = gp_trainer.fit_dkl(model, X, y, lm, params0, cfg=dcfg, generator=gen,
                                 device=dev)
        ends.append({k: params[i].detach().reshape(-1)[sample[k]].double()
                     for k, i in leaf_index.items()})
        del ends[1:-1]
        sync(dev)
        return res

    fault = ctx.fault() if ctx.fault else contextlib.nullcontext()
    with fault, recording(gp_trainer, mll_mod, cfg, log, leaf_index, sample):
        first = call()
        log[0][0].pop("leaf_grads")     # the latest call's are checked
        first_raw = program.raw_of(cfg, first.gp_params)
        route = first.route
        del first
        setup_s = now() - ctx.t_start

        spans, totals = [], {}
        if ctx.trace:
            obs.enable_tracing(None)
        before = program.launches()
        pairs0, mb0 = _counter("moe.routed_pairs_held"), _counter("dkl.microbatches")
        steps = calls = 0
        with tracing.Session(ctx.trace, os.path.join(ctx.run_dir, "trace.json")) as ts:
            t0 = now()
            while True:
                res = call()
                steps += len(res.loss_trace)
                calls += 1
                final_raw = program.raw_of(cfg, res.gp_params)
                del res
                if now() - t0 >= ctx.seconds:
                    break
            t1 = now()
        launched = program.since(before)
        pairs = _counter("moe.routed_pairs_held") - pairs0
        micro = _counter("dkl.microbatches") - mb0
        if ctx.trace:
            spans = obs.drain_events()
            obs.disable_tracing(snapshot_metrics=False)
            totals = span_ms()
    peak = peak_bytes(dev)
    n, s = X.shape
    # the forwards a step runs, each counted by `moe.routed_pairs_held`: the
    # features' (no_grad on the micro-batch route), the backward's own on
    # that route, and the recompute under remat
    forwards = (2 if route == "microbatch" else 1) + int(arch.remat)
    records = {"steps": steps, "calls": calls, "window_s": t1 - t0, "spans": spans,
               "span_ms": totals, "launches": launched, "profile": ts.result,
               "shape": {"n": n, "d": arch.d_model, "t": 1 + g["num_probes"]},
               "factors": cfg["factors"], "precond_rank": g["precond_rank"],
               "leaves": len(cfg["leaves"]) - 1, "config": cfg, "tokens": n * s,
               "seq": s, "moe_pairs": pairs, "microbatches": micro, "route": route,
               "forwards": forwards}
    e2e = {"setup_s": setup_s, "train_step_s": (t1 - t0) / steps}
    runs = [{"steps": log[0], "final": first_raw, "ends": ends[0]},
            {"steps": log[-1], "final": final_raw, "ends": ends[-1]}]
    del gen, params0, model, gp, log, ends

    # the check; the controls run the program again from the set-up weights
    if ctx.capture is None:
        del lm, params
    else:
        with torch.no_grad():
            for p, s_ in zip(params, snapshot):
                p.data.copy_(s_)
    W32 = {k: v.float() for k, v in zip(names, snapshot)}
    del snapshot
    free(dev)
    pick = torch.randperm(n, generator=data.generator(ctx.seed, "cpu"))[:dk["check_sequences"]]
    nums = dkl_checks(cfg, tr, X, y, raw0, runs, W32, start, dtypes, pick)
    nums["moe_dropped"] = float(_counter("moe.dropped") - dropped0)
    if ctx.capture is not None:
        ctx.capture.update(cfg=cfg, tr=tr, arch=arch, lm=lm, W32=W32, X=X, y=y,
                           pick=pick, start=start, dtypes=dtypes, runs=runs, nums=dict(nums))
    checks = [Check(k, nums[k], limit) for k, limit in cfg["limits"][LIMITS].items()]
    return Outcome(steps, 0, e2e, records, checks, peak)


def rel_gap(a, b) -> float:
    """|a - b| / |b| in the Frobenius norm, in float64."""
    import torch

    return float(torch.linalg.norm((a - b).double()) / torch.linalg.norm(b.double()))


def _x_grad_at(cfg, st, plain, dtype):
    """Eq. 2's X gradient of a recorded step from its own solutions, probes
    and preconditioner factor (P^-1 z in float64), computed in `dtype`."""
    import torch

    kern = program.ref_kernel(cfg, st["raw"])
    U = st["solutions"].double()
    u_y, t = U[:, 0], U.shape[1] - 1
    P = Precond(st["L"], kern.noise, FP64)
    A = torch.cat([-u_y[:, None], U[:, 1:] / t], 1)
    V = torch.cat([u_y[:, None], P.solve(st["probes"].double())], 1)
    return plain.matern32_x_grad(st["feats"].to(dtype), A.to(dtype), V.to(dtype),
                                 kern.h["ls"], kern.h["scale"])


def x_grad_gap(cfg, st, plain) -> float:
    """The step's g_X against Eq. 2's X gradient, float64."""
    import torch

    return rel_gap(st["g_X"], _x_grad_at(cfg, st, plain, torch.float64))


def judge_call(cfg, tr, y, raw0, run_, plain) -> dict:
    """he-train's judge on every step of a recorded call, each on its own
    features (a one-step run from that step's hyperparameters); `change_gap`
    over the whole call; `x_grad_gap` on every step."""
    finetune = manifest.load_driver("finetune", cfg["bench"])
    out = dict.fromkeys(SOLVE + ("x_grad_gap",), 0.0)
    raw, state = dict(raw0), {}
    for st in run_["steps"]:
        nxt, _ = adam(st["raw"], st["grads"], {}, tr["lr"])
        nums = finetune.judge(cfg, tr, st["feats"], y, st["raw"],
                              {"steps": [st], "final": nxt})
        for k in SOLVE:
            out[k] = max(out[k], nums[k])
        out["x_grad_gap"] = max(out["x_grad_gap"], x_grad_gap(cfg, st, plain))
        raw, state = adam(raw, st["grads"], state, tr["lr"])
        free(st["feats"].device)
    ch_run = {k: run_["final"][k] - raw0[k] for k in raw0}
    ch_ref = {k: raw[k] - raw0[k] for k in raw0}
    out["change_gap"] = max(finetune._leaf_gaps(ch_run, ch_ref))
    return out


def backbone_grad_gap(cfg, plain, W32, X, st, vjp=None) -> tuple:
    """(gap, the reference's VJP): the recorded step's gradients of
    `grad_leaves` against the reference's VJP with its g_X, the worst
    leaf, each relative to its norm."""
    leaves = cfg["dkl"]["grad_leaves"]
    if vjp is None:
        vjp = plain.features_vjp(W32, cfg, X, st["g_X"], leaves, cfg["dkl"]["vjp_block"])
    return max(rel_gap(st["leaf_grads"][k], vjp[k]) for k in leaves), vjp


def adam_chain(w0, grads, lr: float, dtype, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8):
    """Adam's steps (the judge's `reference.adam`, elementwise) from `w0`
    over `grads`, in float64, each new value rounded to `dtype` as the
    program keeps the leaf."""
    import torch

    w, m, v = w0.double(), 0.0, 0.0
    for t, g in enumerate(grads, 1):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        step = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps)
        w = (w - lr * step).to(dtype).double()
    return w


def backbone_change_gap(cfg, tr, start: dict, run_, dtypes: dict) -> float:
    """A recorded call's change of each of `grad_leaves` at its sampled
    elements against `adam_chain`'s over the program's gradients, relative
    to the chain's change, the worst leaf."""
    gaps = []
    for k in cfg["dkl"]["grad_leaves"]:
        ref = adam_chain(start[k], [st["sampled_grads"][k] for st in run_["steps"]],
                         tr["lr"], dtypes[k])
        gaps.append(rel_gap(run_["ends"][k] - start[k], ref - start[k]))
    return max(gaps)


def features_gap(cfg, plain, W32, X, st, pick) -> float:
    """The recorded step's features at the rows `pick` against the
    reference's."""
    rows = pick.to(X.device)
    return rel_gap(st["feats"][rows], plain.pooled_features(W32, cfg, X[rows]))


def dkl_checks(cfg, tr, X, y, raw0, runs, W32, start, dtypes, pick) -> dict:
    """Every number of the check but `moe_dropped` (see the module); the
    seconds each part took go to standard error."""
    import sys

    plain = backbone_reference(cfg)
    t = now()
    out = {"features_gap": features_gap(cfg, plain, W32, X, runs[-1]["steps"][0], pick)}
    took = {"features": now() - t}
    t = now()
    for r in runs:
        for k, v in judge_call(cfg, tr, y, raw0, r, plain).items():
            out[k] = max(out.get(k, 0.0), v)
    took["gp_head"] = now() - t
    out["backbone_change_gap"] = max(backbone_change_gap(cfg, tr, start, r, dtypes)
                                     for r in runs)
    t = now()
    out["backbone_grad_gap"], _ = backbone_grad_gap(cfg, plain, W32, X, runs[-1]["steps"][0])
    took["backbone_vjp"] = now() - t
    print("dkl check seconds " + " ".join(f"{k} {v:.1f}" for k, v in took.items()),
          file=sys.stderr, flush=True)
    return out


# --------------------------------------------------------------------------
# controls: stand-ins in the program's place
# --------------------------------------------------------------------------


def _e4m3(a):
    """`a`'s values rounded to fp8 e4m3 under a per-tensor scale to its
    range, in a's dtype; its gradient passes to `a` unchanged."""
    import torch

    d = a.detach()
    scale = d.abs().amax().float().clamp(min=1e-30) / 448.0
    r = ((d.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(a.dtype)
    return a + (r - d)


@contextlib.contextmanager
def fp8_operands():
    """Every matmul of two bf16 operands takes them rounded to fp8 e4m3 (a
    backward through them uses the rounded values it saved)."""
    import torch
    from torch.overrides import TorchFunctionMode

    mm = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__}

    class Mode(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in mm and all(isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16
                                  for a in args[:2]):
                args = (_e4m3(args[0]), _e4m3(args[1])) + tuple(args[2:])
            return func(*args, **(kwargs or {}))

    with Mode():
        yield


@contextlib.contextmanager
def capacity_routing(seq: int, n_experts: int, factor: float = 1.25):
    """`hybrid_moe.dispatch` keeping at most max(int(factor k S / E), 1) held
    pairs an expert from each sequence, in token order (the capacity routing
    of `models/moe.py`); the rest are dropped."""
    import torch
    from repro_torch.models import hybrid_moe

    dispatch = hybrid_moe.dispatch

    def capped(top_i, gates, held):
        tok, gate, sizes = dispatch(top_i, gates, held)
        pairs = int(sizes.sum())
        tok, gate = tok[:pairs], gate[:pairs]
        cap = max(int(factor * top_i.shape[1] * seq / n_experts), 1)
        e = torch.repeat_interleave(torch.arange(len(sizes), device=tok.device), sizes)
        key = e * (top_i.shape[0] // seq + 1) + tok // seq
        _, counts = torch.unique_consecutive(key, return_counts=True)
        starts = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
        keep = torch.arange(key.shape[0], device=key.device) - starts < cap
        return tok[keep], gate[keep], torch.bincount(e[keep], minlength=len(sizes))

    hybrid_moe.dispatch = capped
    try:
        yield
    finally:
        hybrid_moe.dispatch = dispatch


def program_vjp(arch, lm, X, g_X, names, block: int) -> dict:
    """The program's gradient of the leaves `names` of its pooled features
    of X with the feature gradient g_X, in blocks of `block` sequences
    without remat, summed in fp32."""
    import torch
    from repro_torch.core.dkl import pooled_features

    params = dict(lm.named_parameters())
    leaves = [params[k] for k in names]
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
    arch = arch._replace(remat=False)
    for i in range(0, X.shape[0], block):
        f = pooled_features(arch, lm, X[i:i + block], device=X.device)
        for a, g in zip(acc, torch.autograd.grad(f, leaves, grad_outputs=g_X[i:i + block])):
            a += g
    return dict(zip(names, acc))


def controls(cap: dict, full: bool = True) -> dict:
    """`program`: every number of the captured run, `logdet_gap` included;
    with `full`, each stand-in's reading of the numbers it must fail: `fp8`
    (the backbone's bf16 matmul operands rounded to fp8 e4m3, per-tensor
    scaled: the precision below the configuration's) on `features_gap` and,
    its gradient in blocks of `vjp_block` sequences, on
    `backbone_grad_gap`; `capacity` (routing with capacity factor 1.25,
    dropping) on `features_gap` and `moe_dropped`; `residual` (no residual
    multiplier) on `features_gap`; `half_g_x` (the backbone gradient from
    the first half of the sequences' g_X) on `backbone_grad_gap`;
    `unchanged` (the backbone left as set-up made it) on
    `backbone_change_gap`; on the GP head, at the latest call's first step
    on its features, he-train's stand-ins (`drivers/finetune.py:
    stand_ins`: `tf32`, `half`, `altered`) and `tf32_x`, Eq. 2's X gradient
    in fp32 with TF32 products in the program's place, on `x_grad_gap`. The
    program's stand-ins run from the set-up weights, on the check's rows."""
    import torch
    from repro_torch.core.dkl import pooled_features

    out = {"program": cap["nums"]}
    if not full:
        return out
    cfg, tr, arch, lm, W32 = cap["cfg"], cap["tr"], cap["arch"], cap["lm"], cap["W32"]
    X, runs = cap["X"], cap["runs"]
    st = runs[-1]["steps"][0]
    finetune = manifest.load_driver("finetune", cfg["bench"])
    nxt, _ = adam(st["raw"], st["grads"], {}, tr["lr"])
    out.update(finetune.stand_ins(cfg, tr, st["feats"], cap["y"], st["raw"],
                                  {"steps": [st], "final": nxt}))
    plain = backbone_reference(cfg)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = dict(st, g_X=_x_grad_at(cfg, st, plain, torch.float32))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    out["tf32_x"] = {"x_grad_gap": x_grad_gap(cfg, tf32, plain)}
    tokens = X[cap["pick"].to(X.device)]
    ref_feats = plain.pooled_features(W32, cfg, tokens)

    def gap(a, ctx_=contextlib.nullcontext()):
        with ctx_, torch.no_grad():
            return rel_gap(pooled_features(a, lm, tokens, device=tokens.device), ref_feats)

    out["fp8"] = {"features_gap": gap(arch, fp8_operands())}
    dropped = _counter("moe.dropped")
    out["capacity"] = {"features_gap": gap(arch, capacity_routing(tokens.shape[1],
                                                                  arch.n_experts)),
                       "moe_dropped": float(_counter("moe.dropped") - dropped)}
    out["residual"] = {"features_gap": gap(arch._replace(residual_multiplier=1.0))}
    out["unchanged"] = {"backbone_change_gap": max(
        backbone_change_gap(cfg, tr, cap["start"], dict(r, ends=cap["start"]), cap["dtypes"])
        for r in runs)}
    leaves, block = cfg["dkl"]["grad_leaves"], cfg["dkl"]["vjp_block"]
    _, full_vjp = backbone_grad_gap(cfg, plain, W32, X, st)
    with fp8_operands():
        fp8 = program_vjp(arch, lm, X, st["g_X"], leaves, block)
    out["fp8"]["backbone_grad_gap"] = max(rel_gap(fp8[k], full_vjp[k]) for k in leaves)
    del lm, cap["lm"], fp8
    free(X.device)
    h = X.shape[0] // 2
    half = plain.features_vjp(W32, cfg, X[:h], st["g_X"][:h], leaves, block)
    out["half_g_x"] = {"backbone_grad_gap": max(rel_gap(half[k], full_vjp[k])
                                                for k in leaves)}
    return out
