"""Hyperparameters from the reference's layout into the port's.

`params_from_numpy(tree, device)` takes a `GPParams` / `KernelParams`
NamedTuple tree of the reference whose leaves are numpy arrays (or anything
`np.asarray` takes) and returns the port's NamedTuples of tensors on
`device`. The classes are matched by name, so nothing of the reference is
imported; this covers every params tree the reference's trainers return
(`GPParams`, `KernelParams` with its per-node `StationaryParams` /
`RQParams` / `LinearParams` / `ScaleParams`, and the baselines'
`SGPRParams` / `SVGPParams`, and deep kernel learning's `MLPParams`).
Artifacts cover the rest of the serving state
(`repro_torch.serve.load_artifact` reads the reference's files).

`lm_params_from_numpy(cfg, tree, device, dtype)` carries the reference's
LM parameter dict (`repro.models.init_params`; blocks and the enc-dec
encoder's `enc_blocks` stacked along a leading layer axis) onto the port's
`LM`: layer i takes slice i, and the weights keep the reference's
(in, out) layout. Leaves the port keeps in fp32 whatever the model's dtype
(the MoE router, the SSD's `A_log`, `dt_bias`, `D`) stay fp32.

`decode_state_from_numpy` / `decode_state_to_numpy` carry a decode state
between the reference's layout (every cache leaf stacked (L, ...), `t` a
scalar array) and the port's (a list of per-layer cache dicts, `t` an int).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import dkl, kernels_math, sgpr, svgp
from repro_torch.device import resolve_device

_MODULES = (kernels_math, sgpr, svgp, dkl)


def _counterpart(name: str):
    for mod in _MODULES:
        cls = getattr(mod, name, None)
        if cls is not None:
            return cls
    return None


def params_from_numpy(tree, device=None):
    """Reference params tree (numpy leaves) -> the port's, on `device`."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = _counterpart(type(tree).__name__)
        if cls is None or getattr(cls, "_fields", None) != tree._fields:
            raise TypeError(f"no counterpart for {type(tree).__name__}")
        return cls(*(params_from_numpy(v, device) for v in tree))
    if isinstance(tree, tuple):
        return tuple(params_from_numpy(v, device) for v in tree)
    return torch.as_tensor(np.array(tree), device=device)


def mlp_params_from_numpy(tree, device=None) -> dkl.MLPParams:
    """The reference's `MLPParams` (numpy leaves) -> the port's."""
    if type(tree).__name__ != "MLPParams":
        raise TypeError(f"expected MLPParams, got {type(tree).__name__}")
    return params_from_numpy(tree, device)


def lm_reference_leaf(tree, name: str) -> np.ndarray:
    """The array of the reference's LM tree that the port's parameter
    `name` (`LM.named_parameters()`) holds: `blocks.<i>.<key>...` is slice
    i of the stacked `tree["blocks"][<key>]...` (and so for
    `enc_blocks`)."""
    parts = name.split(".")
    layer = None
    if parts[0] in ("blocks", "enc_blocks"):
        layer, parts = int(parts[1]), [parts[0]] + parts[2:]
    node = tree
    for key in parts:
        node = node[key]
    node = np.asarray(node)
    return node if layer is None else node[layer]


def lm_params_from_numpy(cfg, tree, device=None, dtype=torch.float32):
    """The reference's LM params (numpy leaves) as the port's `LM` on
    `device` (None = the card) in `dtype`."""
    from repro_torch.models.model import LM

    lm = LM(cfg, dtype=dtype, device="meta").to_empty(device=resolve_device(device))
    with torch.no_grad():
        for name, p in lm.named_parameters():
            leaf = lm_reference_leaf(tree, name)
            if tuple(leaf.shape) != tuple(p.shape):
                raise ValueError(f"{name}: reference {leaf.shape} vs {tuple(p.shape)}")
            p.copy_(torch.as_tensor(np.array(leaf)))
    return lm


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def decode_state_from_numpy(state, device=None) -> dict:
    """The reference's decode state (numpy leaves: caches stacked (L, ...),
    a scalar `t`) as the port's on `device` (None = the card)."""
    dev = resolve_device(device)
    caches = state["caches"]

    def layer(i):
        return _map_leaves(lambda a: torch.as_tensor(np.array(np.asarray(a)[i]),
                                                     device=dev), caches)

    return {"caches": [layer(i) for i in range(len(next(_leaves(caches))))],
            "t": int(np.asarray(state["t"]))}


def decode_state_to_numpy(state) -> dict:
    """The port's decode state in the reference's layout: each cache leaf
    stacked over layers into one (L, ...) numpy array, `t` an int32
    scalar array."""
    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(c[k] for c in leaves)) for k in leaves[0]}
        return np.stack([a.detach().cpu().numpy() for a in leaves])

    return {"caches": stack(*state["caches"]),
            "t": np.asarray(state["t"], np.int32)}

