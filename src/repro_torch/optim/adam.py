"""Adam / AdamW on params NamedTuple trees (fp32 moments whatever the
param dtype), step for step the reference's `repro.optim.adam`, and the
LM trainer's `clip_by_global_norm`."""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.kernels_math import params_leaves, params_unflatten


class AdamState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: object           # tree like params, fp32
    nu: object           # tree like params, fp32


def adam_init(params) -> AdamState:
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in params_leaves(params)]
    return AdamState(step=torch.zeros((), dtype=torch.int32),
                     mu=params_unflatten(params, zeros),
                     nu=params_unflatten(params, [z.clone() for z in zeros]))


def adam_update(params, grads, state: AdamState, lr, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0):
    """One AdamW step; `lr` is a scalar or a callable of the step index.
    Returns (params, state)."""
    step = state.step + 1
    if callable(lr):
        lr = lr(step)
    lr = torch.as_tensor(lr, dtype=torch.float32)
    stepf = step.to(torch.float32)
    c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32), stepf)
    c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32), stepf)

    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(params_leaves(params), params_leaves(grads),
                          params_leaves(state.mu), params_leaves(state.nu)):
        dev = p.device
        g32 = g.detach().to(torch.float32)
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * g32 * g32
        delta = (m / c1.to(dev)) / (torch.sqrt(v / c2.to(dev)) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.detach().to(torch.float32)
        new_p.append((p.detach().to(torch.float32) - lr.to(dev) * delta)
                     .to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return params_unflatten(params, new_p), AdamState(
        step=step, mu=params_unflatten(params, new_m),
        nu=params_unflatten(params, new_v))


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _tree_leaves(t)]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so their global L2 norm is at most `max_norm`, the
    norm before scaling). `grads` is a dict / tuple / NamedTuple tree of
    tensors; the norm is fp32 and each leaf keeps its dtype. Over DTensor
    leaves of any layouts the sum of squares is the global one on every
    rank: a sharded leaf's local sum is a partial sum, which DTensor
    reduces over its mesh before the square root."""
    leaves = _tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return _tree_map(lambda g: (g * scale).to(g.dtype), grads), gn
