"""Step factories: the LM's train / prefill / decode steps and the GP
workload's MLL step and mean-cache solve.

The counterpart of `repro.launch.steps`. Each LM factory binds an
ArchConfig to a mesh and installs it (`shardctx.use_mesh`) around the step,
so the model's layout points redistribute DTensor activations to the
reference's specs; with plain tensors (one card, the CPU tests) they are
the identity. `launch.dryrun` counts these steps on fake tensors;
`launch.train` and the examples run them for real.

`TrainState` holds the LM's parameters as a {name: tensor} dict (the names
of `LM.named_parameters()`), fp32 Adam moments of the same names, and the
int32 step. The train step is functional: it returns a new state and
leaves the one it was given untouched, so the fault-tolerant loop
(`train.trainer`) can drop a step whose metrics are bad and keep the old
state. Its cost is one spare copy of the state while a step is in flight
(the new bf16 parameters and fp32 moments, 10 bytes per parameter beside
the 10 of the old state), as the reference's non-donating jit has.

The GP workload (gp-exact-1m) gets its factories at the bottom: the
paper's distributed MLL step and the prediction-cache solve on the same
mesh, run on every rank (`repro_torch.core.distributed`).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.models import init_params, train_loss
from repro_torch.models.model import LM
from repro_torch.models.model import decode_step as model_decode_step
from repro_torch.models.model import prefill
from repro_torch.models.sharding import param_pspec
from repro_torch.models.shardctx import (
    ReplicateOnFailure, is_dtensor, gathered, use_mesh,
)
from repro_torch.optim.adam import _tree_leaves, _tree_map, clip_by_global_norm


class TrainState(NamedTuple):
    params: dict        # {name: tensor}, the LM's parameters
    mu: dict            # fp32 Adam moments
    nu: dict
    step: torch.Tensor  # () int32


def init_train_state(cfg, generator: torch.Generator | None = None,
                     dtype=torch.bfloat16, device=None) -> TrainState:
    """A fresh LM (bf16 by default, as the reference's) and zero moments on
    `device` (None = the card)."""
    lm = init_params(cfg, generator, dtype, device)
    params = {k: p.detach() for k, p in lm.named_parameters()}
    mu = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
          for k, p in params.items()}
    nu = {k: v.clone() for k, v in mu.items()}
    step = torch.zeros((), dtype=torch.int32, device=lm.embed.device)
    return TrainState(params=params, mu=mu, nu=nu, step=step)


def train_state_shardings(mesh, state_or_specs: TrainState) -> TrainState:
    """Specs of a TrainState: parameters and moments by `param_pspec`, the
    step replicated. Only the leaves' shapes are read, so a state of
    `meta` tensors serves as the reference's `eval_shape` specs do."""
    ps = {k: param_pspec(mesh, k, tuple(p.shape))
          for k, p in state_or_specs.params.items()}
    return TrainState(params=ps, mu=dict(ps), nu=dict(ps), step=())


def place_train_state(mesh, state: TrainState) -> TrainState:
    """A host-canonical TrainState (full tensors, the same on every rank)
    placed on `mesh` as DTensors: parameters and both moments laid out by
    `param_pspec` (`train_state_shardings`), the step replicated. Each
    rank keeps its own shard of its full copy and nothing is communicated
    (`train.elastic.reshard`). The first placement and a resume both go
    through here, so a checkpoint written on one mesh restores onto
    another."""
    from repro_torch.train.elastic import reshard

    def pspec(path: str, leaf) -> tuple:
        # checkpoint paths: .params['blocks.0.mlp.wi'], .mu[...], .nu[...], .step
        if path == ".step":
            return ()
        return param_pspec(mesh, path[path.index("['") + 2:-2], tuple(leaf.shape))

    return reshard(state, mesh, pspec)


def _unflatten_like(template, leaves):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), template)


def _adamw(params, grads, mu, nu, step, *, lr=3e-4, b1=0.9, b2=0.95,
           eps=1e-8, wd=0.1):
    """The reference's AdamW, leaf for leaf: bias-corrected fp32 moments,
    decoupled weight decay on every leaf, the update in fp32 cast back to
    the parameter's dtype. Trees are dicts or NamedTuples of tensors; new
    tensors are returned and the inputs are not touched."""
    step = step + 1
    t = step.to(torch.float32)
    c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
    c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)

    out_p, out_m, out_v = [], [], []
    for p, g, m, v in zip(_tree_leaves(params), _tree_leaves(grads),
                          _tree_leaves(mu), _tree_leaves(nu)):
        g32 = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * g32 * g32
        mh = m / c1
        vh = v / c2
        p32 = p.to(torch.float32)
        p32 = p32 - lr * (mh / (torch.sqrt(vh) + eps) + wd * p32)
        out_p.append(p32.to(p.dtype))
        out_m.append(m)
        out_v.append(v)
    return (_unflatten_like(params, out_p), _unflatten_like(params, out_m),
            _unflatten_like(params, out_v), step)


@contextlib.contextmanager
def _bound(lm: LM, params: dict, *, grad: bool = True):
    """`lm` with the given tensors as its parameters for the duration: each
    becomes a fresh leaf `nn.Parameter` sharing the tensor's storage (so
    gradients w.r.t. the yielded leaves are the step's), bound through
    `shardctx.gathered` (under a mesh, a DTensor weight's FSDP all-gather;
    else the leaf itself). Bound for the whole forward and backward, since
    the blocks' activation checkpoints re-run the modules in the backward."""
    slots, leaves = [], []
    for name, t in params.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = lm.get_submodule(mod_name) if mod_name else lm
        p = nn.Parameter(t.detach(), requires_grad=grad)
        slots.append((mod, leaf, mod._parameters[leaf]))
        leaves.append(p)
        mod._parameters[leaf] = gathered(p)
    try:
        yield leaves
    finally:
        for mod, leaf, old in slots:
            mod._parameters[leaf] = old


def _slice_batch(batch: dict, i: int, mb: int) -> dict:
    """Microbatch i of mb: rows [i * n, (i + 1) * n) of the batch, or of
    each rank's local rows for a batch-sharded DTensor."""
    def one(x):
        if not is_dtensor(x):
            n = x.shape[0] // mb
            return x[i * n:(i + 1) * n]
        from torch.distributed.tensor import DTensor

        loc = x.to_local()
        n = loc.shape[0] // mb
        return DTensor.from_local(loc[i * n:(i + 1) * n], x.device_mesh,
                                  x.placements, run_check=False)
    return {k: one(v) for k, v in batch.items()}


def _replicated(x):
    """A DTensor metric as a replicated one (partial sums reduced); a plain
    tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    want = [Replicate()] * x.device_mesh.ndim
    return x if list(x.placements) == want else x.redistribute(x.device_mesh, want)


@contextlib.contextmanager
def _dtensor_step(fallbacks: dict):
    """Around a step on DTensor state: a plain tensor made inside the step
    (positions, masks, constants, the same on every rank) acts as a
    replicated one, and an op of `shardctx.REPLICATE_OK` that DTensor
    cannot shard runs on replicated operands; each such op is counted
    into `fallbacks`."""
    from torch.distributed.tensor.experimental import implicit_replication

    mode = ReplicateOnFailure()
    with implicit_replication(), mode:
        yield
    for k, n in mode.fallbacks.items():
        fallbacks[k] = fallbacks.get(k, 0) + n


def make_train_step(cfg, mesh=None, *, lr=3e-4, microbatch: int = 1):
    """step_fn(state, batch) -> (new_state, metrics): loss and backward
    (with `microbatch > 1`, the mean over equal batch slices, each slice's
    backward run in turn), `clip_by_global_norm(grads, 1.0)`, then
    `_adamw`, under `use_mesh(mesh)`. Metrics are 0-d tensors: loss,
    grad_norm and the model's (ce, moe_aux).

    On DTensor state (`place_train_state`) and a batch sharded over the
    data axes (`data.tokens.TokenPipeline` with a mesh) the same code
    trains over the mesh: each weight is all-gathered over the FSDP axes
    where the model reads it (`_bound`), its gradient comes back laid out
    as the weight (the partial sums reduce-scattered), AdamW runs on each
    rank's shards, and the metrics come out replicated: the global
    batch's values on every rank. `step_fn.fallbacks` counts the ops
    that ran on replicated operands (`shardctx.REPLICATE_OK`)."""
    skeleton = LM(cfg, device="meta")

    def loss_and_grads(params, batch):
        with _bound(skeleton, params) as leaves, torch.enable_grad():
            loss, metrics = train_loss(cfg, skeleton, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a parameter the loss never reads (OLMo's placeholder norm weight)
        # gets a zero gradient, as under jax.grad
        grads = [torch.zeros_like(a) if g is None else _laid_out_as(g, a)
                 for a, g in zip(leaves, grads)]
        return (_replicated(loss.detach()),
                {k: _replicated(v.detach()) for k, v in metrics.items()},
                dict(zip(params, grads)))

    def step_fn(state: TrainState, batch: dict):
        sharded = is_dtensor(state.step)
        with use_mesh(mesh), (_dtensor_step(step_fn.fallbacks) if sharded
                              else contextlib.nullcontext()):
            if microbatch == 1:
                loss, metrics, grads = loss_and_grads(state.params, batch)
            else:
                # the mean over equal slices, accumulated one slice at a time
                for i in range(microbatch):
                    part = loss_and_grads(state.params,
                                          _slice_batch(batch, i, microbatch))
                    if i == 0:
                        loss, metrics, grads = part
                        continue
                    loss = loss + part[0]
                    metrics = {k: v + part[1][k] for k, v in metrics.items()}
                    grads = {k: v + part[2][k] for k, v in grads.items()}
                loss = loss / microbatch
                metrics = {k: v / microbatch for k, v in metrics.items()}
                grads = {k: v / microbatch for k, v in grads.items()}
            grads, gnorm = clip_by_global_norm(grads, 1.0)
            params, mu, nu, step = _adamw(state.params, grads, state.mu,
                                          state.nu, state.step, lr=lr)
        return (TrainState(params, mu, nu, step),
                {"loss": loss, "grad_norm": _replicated(gnorm), **metrics})

    step_fn.fallbacks = {}
    return step_fn


def _laid_out_as(g, p):
    """A DTensor gradient in its parameter's layout (partial sums reduced
    or reduce-scattered); a plain one as it is."""
    if not is_dtensor(g) or list(g.placements) == list(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def _serving(fn):
    """Under a mesh, run `fn` with the LM's weights in their compute layout
    (`_bound`, no gradients)."""
    def step_fn(mesh, lm, state, x):
        with use_mesh(mesh):
            if mesh is None:
                return fn(lm, state, x)
            with _bound(lm, dict(lm.named_parameters()), grad=False):
                return fn(lm, state, x)
    return step_fn


def make_prefill_step(cfg, mesh=None):
    """step_fn(lm, state, batch) -> (state, last-token logits)."""
    run = _serving(lambda lm, state, batch: prefill(cfg, lm, state, batch))
    return lambda lm, state, batch: run(mesh, lm, state, batch)


def make_decode_step(cfg, mesh=None):
    """step_fn(lm, state, tokens) -> (state, logits)."""
    run = _serving(lambda lm, state, tok: model_decode_step(cfg, lm, state, tok))
    return lambda lm, state, tokens: run(mesh, lm, state, tokens)


def metrics_shardings(mesh, metrics) -> dict:
    """Specs of a step's metrics: every one replicated."""
    return {k: () for k in metrics}


# ---------------------------------------------------------------------------
# GP workload steps (the paper's own dry-run cells)
# ---------------------------------------------------------------------------


def _gp_geometry(gp_cfg, mesh):
    from repro_torch.core.distributed import make_geometry

    return make_geometry(mesh, gp_cfg.n, gp_cfg.d, mode=gp_cfg.mode,
                         row_block=gp_cfg.row_block,
                         overlap=getattr(gp_cfg, "overlap", False))


def make_gp_train_step(gp_cfg, mesh, *, lr: float = 0.1,
                       pcg_method: str = "standard",
                       fixed_iters: bool = False):
    """(step_fn, geom). step_fn(X, y_loc, params, mu, nu, step, generator,
    probes=None) -> (mll value, params, mu, nu, step): one BBMM MLL AdamW
    step (no weight decay) on every rank, gradients all-reduced. X is full
    on every rank, y_loc this rank's chunk; `probes` (this rank's chunk)
    replaces the draw from `generator`. `fixed_iters` runs exactly
    `train_cg_iters` CG iterations (the dry run's trip count)."""
    from repro_torch.core.distributed import DistMLLConfig, make_dist_mll
    from repro_torch.core.kernels_math import params_leaves, params_unflatten

    geom = _gp_geometry(gp_cfg, mesh)
    cfg = DistMLLConfig(kernel=gp_cfg.kernel, precond_rank=gp_cfg.precond_rank,
                        num_probes=gp_cfg.num_probes,
                        max_cg_iters=gp_cfg.train_cg_iters,
                        min_cg_iters=(gp_cfg.train_cg_iters if fixed_iters
                                      else DistMLLConfig().min_cg_iters),
                        pcg_method=pcg_method, backend=gp_cfg.backend,
                        compute_dtype=gp_cfg.compute_dtype)
    mll = make_dist_mll(geom, cfg)

    def step_fn(X, y_loc, params, mu, nu, step, generator=None, probes=None):
        leaves = [a.detach().requires_grad_(True) for a in params_leaves(params)]
        with torch.enable_grad():
            value, _ = mll(X, y_loc, params_unflatten(params, leaves),
                           generator, probes=probes)
            g = torch.autograd.grad(-value / geom.n, leaves)
        params, mu, nu, step = _adamw(params, params_unflatten(params, list(g)),
                                      mu, nu, step, lr=lr, wd=0.0)
        return value.detach(), params, mu, nu, step

    return step_fn, geom


def make_gp_predict_setup(gp_cfg, mesh, *, fixed_iters: bool = False):
    """(solve_fn, geom): the tight-tolerance mean-cache solve (the paper's
    precomputation), solve_fn(X, y_loc, params) -> (a, rel_residual).
    `fixed_iters` runs exactly `pred_cg_iters` CG iterations."""
    from repro_torch.core.distributed import DistMLLConfig, make_mean_cache_solve

    geom = _gp_geometry(gp_cfg, mesh)
    cfg = DistMLLConfig(kernel=gp_cfg.kernel, precond_rank=gp_cfg.precond_rank,
                        backend=gp_cfg.backend,
                        compute_dtype=gp_cfg.compute_dtype)
    it = gp_cfg.pred_cg_iters
    return make_mean_cache_solve(mesh, geom, cfg, tol=0.01, max_iters=it,
                                 min_iters=it if fixed_iters else 10), geom
