"""GP hyperparameter training — the paper's exact procedure, on one device.

The counterpart of `repro.train.gp_trainer.fit_exact_gp`:

    "pretrain"  the paper's Fig. 1 procedure: L-BFGS then Adam(0.1) on a
                random subset, then a few Adam steps on the full data;
    "adam"      plain Adam on the full data (appendix Table 5).

Full-data stages run on the warm-started solve engine
(`repro_torch.train.solver_state.WarmStartEngine`). On the `blocksparse`
backend each full-data stage plans the block mask for its inputs, and the
loop replans whenever the hyperparameter drift exceeds
`cfg.drift_threshold` (the plan's margin) or the support radius outgrows
the plan. Randomness (subset choice, SLQ probes, the Lanczos start vector)
comes from a `torch.Generator` seeded from `cfg.seed` (or the caller's);
the reference draws from jax keys, so the two packages fit with different
probes. On the `pallas` backend with `autotune` set, each full-data stage
resolves the fused kernels' column split for its training shape first
(`repro_torch.kernels.autotune.prewarm`), so a sweep's time lands in set-up.

`fit_dkl` trains a deep-kernel-learning model (`repro_torch.core.dkl`):
Adam over the backbone's leaves and the GP head's together, the head's MLL
through `ExactGP.mll` (the `_ExactMLL` Function and its Eq. 2 backward,
which hands the backbone its feature gradient g_X). A port-only entry.

Also the paper's baselines, with the reference's settings: `fit_sgpr` (100
steps of Adam(0.1), m = 512) and `fit_svgp` (100 epochs of Adam(0.01),
batch 1024, m = 1024; the epochs' permutations from
`np.random.default_rng(seed)`, as the reference draws them, so both packages
visit the same minibatches).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.gp import ExactGP
from repro_torch.core.kernels_math import (
    GPParams,
    params_leaves,
    params_map,
    params_unflatten,
)
from repro_torch.core.sgpr import SGPRParams, init_sgpr_params, sgpr_loss
from repro_torch.core.svgp import SVGPParams, init_svgp_params, svgp_loss
from repro_torch.device import resolve_device
from repro_torch.optim import AdamState, adam_init, adam_update, lbfgs_minimize
from repro_torch.train.solver_state import WarmStartConfig, WarmStartEngine


class GPTrainConfig(NamedTuple):
    """The reference's field names and defaults."""

    pretrain_subset: int = 10_000
    pretrain_lbfgs_steps: int = 10
    pretrain_adam_steps: int = 10
    pretrain_adam_lr: float = 0.1
    finetune_adam_steps: int = 3
    finetune_adam_lr: float = 0.1
    plain_adam_steps: int = 100
    plain_adam_lr: float = 0.1
    seed: int = 0
    warm_start: bool = True
    refresh_every: int = 5
    drift_threshold: float = 0.1

    def warm_config(self) -> WarmStartConfig:
        return WarmStartConfig(enabled=self.warm_start,
                               refresh_every=self.refresh_every,
                               drift_threshold=self.drift_threshold)


class GPFitResult(NamedTuple):
    params: GPParams
    loss_trace: list
    seconds: float
    # per-step solver telemetry of the full-data stage: the records of
    # `obs.record_solver_step` (mode, refreshed, cg_iters, cg_iters_per_rhs,
    # drift, seconds, mvm_launches, hbm_bytes_modeled; measured_phase_ms
    # under tracing)
    telemetry: tuple = ()
    # blocksparse replans of the full-data stage: (step, drift, fill)
    replans: tuple = ()


def _value_and_grad(loss_fn, params):
    leaves = [a.detach().requires_grad_(True) for a in params_leaves(params)]
    val = loss_fn(params_unflatten(params, leaves))
    grads = torch.autograd.grad(val, leaves, allow_unused=True)
    return val.detach(), params_unflatten(params, [
        torch.zeros_like(a) if g is None else g for a, g in zip(leaves, grads)])


def _draw_seed(generator: torch.Generator) -> int:
    """A seed drawn from `generator`'s stream."""
    return int(torch.randint(0, 2**62, (1,), generator=generator,
                             device=generator.device))


def _fence(dev: torch.device) -> None:
    """Under tracing, wait for the card so a span ends with its work."""
    if obs.tracing_enabled() and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _start_params(params0, init, dev):
    """`params0` on `dev` (tensors or numpy leaves), else `init()`."""
    if params0 is None:
        return init()
    return params_map(lambda a: torch.as_tensor(a, device=dev), params0)


def fit_exact_gp(gp: ExactGP, X, y, *, cfg: GPTrainConfig = GPTrainConfig(),
                 method: str = "pretrain", noise_init: float = 0.5,
                 verbose: bool = False, save_artifact: str | None = None,
                 params0=None, generator: torch.Generator | None = None,
                 device=None) -> GPFitResult:
    """Fit GP hyperparameters by maximizing the BBMM MLL.

    method: "pretrain" (Fig. 1) or "adam" (Table 5). params0: start from
    these hyperparameters instead of `gp.init_params(d, noise=noise_init)`.
    generator: the randomness (None = a generator on the device seeded with
    `cfg.seed`). device: where the fit runs (None = the card; raises when
    there is none). save_artifact: after fitting, run the one-time
    precomputation and save a `repro_torch.serve` PosteriorArtifact there.

    Observability, as the reference's: under `obs.trace_session` (or
    REPRO_TORCH_OBS_TRACE) the fit emits a `fit_exact_gp` root span with a
    span per stage (`pretrain_lbfgs`, `pretrain_adam`, `sparse_plan`,
    `autotune`, `sparse_replan`, `optimizer_step`, `save_artifact`) and,
    inside the full-data steps, the engine's `mll_step` and phase spans;
    with profiling on, `memory_snapshot` at the stage bounds and a
    `step_annotation` around each full-data step. All of it is a no-op by
    default.
    """
    dev = resolve_device(device)
    with obs.span("fit_exact_gp", method=method, n=int(X.shape[0]),
                  backend=gp.config.backend):
        return _fit_exact_gp(gp, X, y, cfg=cfg, method=method,
                             noise_init=noise_init, verbose=verbose,
                             save_artifact=save_artifact, params0=params0,
                             generator=generator, dev=dev)


def _fit_exact_gp(gp, X, y, *, cfg, method, noise_init, verbose,
                  save_artifact, params0, generator, dev) -> GPFitResult:
    t0 = time.time()
    gp = ExactGP(gp.config, device=dev)
    X = torch.as_tensor(X, device=dev)
    y = torch.as_tensor(y, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    n, d = X.shape
    params = _start_params(
        params0, lambda: gp.init_params(d, noise=noise_init, dtype=X.dtype), dev)
    blocksparse = gp.config.backend == "blocksparse"
    trace: list = []
    telemetry: tuple = ()
    replans: list = []

    def stage_gp(p) -> ExactGP:
        """A blocksparse stage gets a plan for its inputs at its incoming
        hyperparameters (a caller's plan is kept if it covers them)."""
        if not blocksparse:
            return gp
        from repro_torch.sparse import build_plan, plan_is_safe

        plan = gp.config.plan
        if plan is not None and plan.n == n \
                and plan_is_safe(plan, gp.config.kernel, p):
            return gp
        plan = build_plan(gp.config.kernel, X, p,
                          tile=max(8, min(gp.config.row_block, 256)),
                          margin=cfg.drift_threshold)
        return gp.replace(plan=plan)

    def subset_gp() -> ExactGP:
        """Subset pretraining runs blocksparse configs on the partitioned
        backend, as the reference's: the subset is small and its
        hyperparameters move a lot."""
        if not blocksparse:
            return gp
        return gp.replace(backend="partitioned", plan=None)

    def run_full_data_stage(steps, lr, params, tag):
        from repro_torch.sparse import build_plan, needs_replan

        obs.memory_snapshot(f"{tag}_start")
        with obs.span("sparse_plan", stage=tag):
            gp_s = stage_gp(params)
        if gp_s.config.backend == "pallas" and gp_s.config.autotune:
            # resolve (and persist) the training shape's column split before
            # the first step, so that the sweep's time lands here
            from repro_torch.kernels.autotune import prewarm

            with obs.span("autotune", stage=tag):
                split = prewarm(gp_s.config.kernel, params, n, d,
                                num_probes=gp_s.config.num_probes, device=dev,
                                compute_dtype=gp_s.config.compute_dtype)
            if verbose:
                print(f"  {tag}: autotuned tiles per split = {split}")
        engine = WarmStartEngine(gp_s.config.mll_config(), cfg.warm_config())
        state = adam_init(params)
        telem: list = []
        for i in range(steps):
            if blocksparse:
                replan, drift = needs_replan(
                    gp_s.config.plan, params, cfg.drift_threshold,
                    kernel=gp_s.config.kernel)
                if replan:
                    telem.extend(engine.telemetry)
                    fill_before = gp_s.config.plan.fill
                    with obs.span("sparse_replan", stage=tag, step=i):
                        plan = build_plan(gp_s.config.kernel, X, params,
                                          tile=gp_s.config.plan.tile,
                                          margin=cfg.drift_threshold)
                    obs.health.sparse_replan(step=i, fill_before=fill_before,
                                             fill_after=plan.fill)
                    replans.append((i, drift, plan.fill))
                    gp_s = gp_s.replace(plan=plan)
                    engine = WarmStartEngine(gp_s.config.mll_config(),
                                             cfg.warm_config())
                    if verbose:
                        print(f"  {tag} {i}: replanned sparsity "
                              f"(drift={drift:.3f}, fill={plan.fill:.3f})")
            with obs.step_annotation(i):
                val, _, g = engine.step(X, y, params, generator)
                with obs.span("optimizer_step", stage=tag, step=i):
                    params, state = adam_update(params, g, state, lr)
                    _fence(dev)
            trace.append(float(val))
            if verbose and (steps <= 10 or i % 10 == 0):
                t = engine.telemetry[-1]
                print(f"  {tag} {i}: {float(val):.5f} [{t['mode']} "
                      f"cg_iters={t['cg_iters']} dt={t['seconds']:.2f}s]")
        telem.extend(engine.telemetry)
        obs.memory_snapshot(f"{tag}_end")
        return params, tuple(telem)

    if method == "pretrain":
        m = min(cfg.pretrain_subset, n)
        idx = torch.randperm(n, generator=generator, device=dev)[:m]
        Xs, ys = X[idx], y[idx]
        gp_sub = subset_gp()
        seed_lbfgs = _draw_seed(generator)

        def loss_lbfgs(p):
            # one fixed probe draw for every evaluation of the line search
            gen = torch.Generator(device=dev).manual_seed(seed_lbfgs)
            return gp_sub.loss(Xs, ys, p, gen)[0]

        with obs.span("pretrain_lbfgs", subset=int(m)):
            params, tr = lbfgs_minimize(loss_lbfgs, params,
                                        max_steps=cfg.pretrain_lbfgs_steps,
                                        verbose=verbose)
            _fence(dev)
        trace += tr
        state = adam_init(params)
        with obs.span("pretrain_adam", subset=int(m)):
            for i in range(cfg.pretrain_adam_steps):
                val, g = _value_and_grad(
                    lambda p: gp_sub.loss(Xs, ys, p, generator)[0], params)
                params, state = adam_update(params, g, state,
                                            cfg.pretrain_adam_lr)
                trace.append(float(val))
                if verbose:
                    print(f"  pretrain adam {i}: {float(val):.5f}")
            _fence(dev)
        obs.memory_snapshot("pretrain_end")
        params, telemetry = run_full_data_stage(
            cfg.finetune_adam_steps, cfg.finetune_adam_lr, params, "finetune")
    elif method == "adam":
        params, telemetry = run_full_data_stage(
            cfg.plain_adam_steps, cfg.plain_adam_lr, params, "adam")
    else:
        raise ValueError(f"unknown method {method!r}")

    if save_artifact is not None:
        from repro_torch.serve.artifact import fit_posterior
        from repro_torch.serve.artifact import save_artifact as _save

        c = gp.config
        # blocksparse: the posterior runs on a plan at the FINAL params
        gp_art = gp.replace(plan=None) if blocksparse else gp
        with obs.span("save_artifact"):
            art = fit_posterior(
                gp_art.operator(X, params), y, generator=generator,
                precond_rank=c.precond_rank, lanczos_rank=c.lanczos_rank,
                pred_tol=c.pred_cg_tol, max_cg_iters=c.pred_max_cg_iters)
            path = _save(save_artifact, art)
        if verbose:
            print(f"  saved posterior artifact: {path} "
                  f"(rel_residual={art.meta['solve_rel_residual']:.2e})")

    return GPFitResult(params=params, loss_trace=trace,
                       seconds=time.time() - t0, telemetry=telemetry,
                       replans=tuple(replans))


def fit_sgpr(kind: str, X, y, num_inducing: int = 512, *, steps: int = 100,
             lr: float = 0.1, seed: int = 0, noise_init: float = 0.5,
             ard: bool = False, verbose: bool = False, params0=None,
             device=None) -> tuple[SGPRParams, list, float]:
    """Paper baseline: SGPR, 100 iterations of Adam(0.1). Returns (params,
    loss trace, seconds). The inducing points come from a generator seeded
    with `seed`; params0: start from these params instead. device None =
    the card."""
    t0 = time.time()
    dev = resolve_device(device)
    X = torch.as_tensor(X, device=dev)
    y = torch.as_tensor(y, device=dev)
    params = _start_params(params0, lambda: init_sgpr_params(
        X, num_inducing, ard_dims=X.shape[1] if ard else None,
        noise=noise_init, dtype=X.dtype,
        generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev), dev)
    state = adam_init(params)
    trace = []
    for i in range(steps):
        val, g = _value_and_grad(lambda p: sgpr_loss(kind, X, y, p), params)
        params, state = adam_update(params, g, state, lr)
        trace.append(float(val))
        if verbose and i % 10 == 0:
            print(f"  sgpr adam {i}: {trace[-1]:.5f}")
    return params, trace, time.time() - t0


def fit_svgp(kind: str, X, y, num_inducing: int = 1024, *, epochs: int = 100,
             batch: int = 1024, lr: float = 0.01, seed: int = 0,
             noise_init: float = 0.5, ard: bool = False,
             verbose: bool = False, params0=None,
             device=None) -> tuple[SVGPParams, list, float]:
    """Paper baseline: SVGP, 100 epochs of Adam(0.01), minibatch 1024.
    Returns (params, the loss of each epoch's last step, seconds). The host
    reads one loss per epoch; each epoch's permutation moves to the device
    once."""
    t0 = time.time()
    dev = resolve_device(device)
    X = torch.as_tensor(X, device=dev)
    y = torch.as_tensor(y, device=dev)
    n = X.shape[0]
    params = _start_params(params0, lambda: init_svgp_params(
        X, num_inducing, ard_dims=X.shape[1] if ard else None,
        noise=noise_init, dtype=X.dtype,
        generator=torch.Generator(device=dev).manual_seed(seed),
        device=dev), dev)
    state = adam_init(params)
    trace = []
    rng = np.random.default_rng(seed)
    steps_per_epoch = max(1, n // batch)
    for e in range(epochs):
        perm = torch.as_tensor(rng.permutation(n), device=dev)
        for s in range(steps_per_epoch):
            sel = perm[s * batch:(s + 1) * batch]
            xb, yb = X[sel], y[sel]
            val, g = _value_and_grad(
                lambda p: svgp_loss(kind, xb, yb, p, n), params)
            params, state = adam_update(params, g, state, lr)
        trace.append(float(val))
        if verbose and e % 10 == 0:
            print(f"  svgp epoch {e}: {trace[-1]:.5f}")
    return params, trace, time.time() - t0


# ---------------------------------------------------------------------------
# deep kernel learning: a backbone and an exact-GP head, trained together
# ---------------------------------------------------------------------------


class DKLTrainConfig(NamedTuple):
    """Adam steps at one learning rate over the backbone and the GP head.

    microbatch: sequences (rows) per backbone micro-batch; 0 = one pass.
    One pass keeps the whole batch's autograd graph from the features to
    the backward. Micro-batches bound it by a batch's share: the features
    of all rows first under `no_grad`, then the MLL and its X gradient
    g_X, then per micro-batch a recomputed forward and a backward with its
    rows of g_X, the gradients accumulated in fp32. The features are per
    row, so both routes give one gradient, up to rounding."""

    adam_steps: int = 3
    lr: float = 3e-3
    microbatch: int = 0


class DKLFitResult(NamedTuple):
    phi_params: object    # the backbone: a module (updated in place) or a tree
    gp_params: GPParams
    state: AdamState      # Adam's over (backbone leaves, GP leaves)
    loss_trace: list
    route: str            # "one_pass" or "microbatch"
    microbatches: int     # backbone micro-batches a step
    seconds: float


def _phi_leaves(phi):
    """(phi as the step uses it, its trainable leaves): a module's
    parameters, or a tree's leaves made leaves of autograd."""
    if isinstance(phi, torch.nn.Module):
        return phi, [p for p in phi.parameters() if p.requires_grad]
    leaves = [a.detach().requires_grad_(True) for a in params_leaves(phi)]
    return params_unflatten(phi, leaves), leaves


def dkl_route(n: int, microbatch: int) -> tuple[str, int]:
    """(route, micro-batches a step) for n rows."""
    if 0 < microbatch < n:
        return "microbatch", -(-n // microbatch)
    return "one_pass", 1


def _dkl_step(model, tokens, y, phi, leaves, gp_params, generator, microbatch):
    """One DKL loss and gradient: (loss, MLLAux, features, g_X, the
    backbone's gradients (one per leaf), the GP head's)."""
    n = tokens.shape[0]
    dev = y.device
    route, _ = dkl_route(n, microbatch)
    mb = microbatch if route == "microbatch" else n
    with obs.span("dkl_features", route=route):
        if route == "one_pass":
            feats = model.phi_apply(phi, tokens)
        else:
            with torch.no_grad():
                feats = torch.cat([model.phi_apply(phi, tokens[i:i + mb])
                                   for i in range(0, n, mb)])
        _fence(dev)
    with obs.span("dkl_gp_head"):
        fx = feats.detach().requires_grad_(True)
        gl = [a.detach().requires_grad_(True) for a in params_leaves(gp_params)]
        value, aux = model.gp.mll(fx, y, params_unflatten(gp_params, gl), generator)
        loss = -value / n
        g_X, *g_gp = torch.autograd.grad(loss, [fx, *gl])
        _fence(dev)
    with obs.span("dkl_backbone_backward", route=route):
        if route == "one_pass":
            g_phi = list(torch.autograd.grad(feats, leaves, grad_outputs=g_X,
                                             allow_unused=True))
        else:
            g_phi = [torch.zeros(a.shape, dtype=torch.float32, device=a.device)
                     for a in leaves]
            for i in range(0, n, mb):
                f = model.phi_apply(phi, tokens[i:i + mb])
                gs = torch.autograd.grad(f, leaves, grad_outputs=g_X[i:i + mb],
                                         allow_unused=True)
                for acc, g in zip(g_phi, gs):
                    if g is not None:
                        acc += g
        g_phi = [torch.zeros_like(a) if g is None else g for a, g in zip(leaves, g_phi)]
        _fence(dev)
    return (loss.detach(), aux, feats.detach(), g_X, g_phi,
            params_unflatten(gp_params, g_gp))


def fit_dkl(model, tokens, y, phi_params, gp_params, *,
            cfg: DKLTrainConfig = DKLTrainConfig(), state: AdamState | None = None,
            generator: torch.Generator | None = None, device=None) -> DKLFitResult:
    """Train a `DKLModel` for `cfg.adam_steps` Adam steps: the loss is the
    per-datum negative MLL of the GP head on `model.phi_apply(phi_params,
    tokens)`, and one Adam (`optim.adam_update`, fp32 moments) at `cfg.lr`
    moves the backbone's leaves and the head's. A module backbone is
    updated in place (its parameters take the new tensors); a tree comes
    back new. `state` continues an Adam state over (backbone leaves, GP
    leaves) (None = a fresh one). generator: the SLQ probes (None = a
    generator on the device seeded 0). device None = the card.

    Under tracing each step emits `dkl_features`, `dkl_gp_head` (the MLL
    forward and backward, up to g_X), `dkl_backbone_backward` and
    `dkl_adam`, each closed by a synchronize; the counter
    `dkl.microbatches` adds the backbone's micro-batches of each step."""
    t0 = time.time()
    dev = resolve_device(device)
    tokens = torch.as_tensor(tokens, device=dev)
    y = torch.as_tensor(y, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    route, count = dkl_route(tokens.shape[0], cfg.microbatch)
    trace: list = []
    phi, leaves = _phi_leaves(phi_params)
    if state is None:
        state = adam_init((tuple(leaves), gp_params))
    for i in range(cfg.adam_steps):
        loss, _, _, _, g_phi, g_gp = _dkl_step(model, tokens, y, phi, leaves, gp_params,
                                               generator, cfg.microbatch)
        obs.counter("dkl.microbatches").inc(count)
        with obs.span("dkl_adam", step=i):
            (new, gp_params), state = adam_update(
                (tuple(leaves), gp_params), (tuple(g_phi), g_gp), state, cfg.lr)
            del g_phi
            if isinstance(phi, torch.nn.Module):
                for p, v in zip(leaves, new):
                    p.data = v
            else:
                phi, leaves = _phi_leaves(params_unflatten(phi, list(new)))
            _fence(dev)
        trace.append(float(loss))
    return DKLFitResult(phi_params=phi, gp_params=gp_params, state=state,
                        loss_trace=trace, route=route, microbatches=count,
                        seconds=time.time() - t0)
