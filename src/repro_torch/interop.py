"""Hyperparameters from the reference's layout into the port's.

`params_from_numpy(tree, device)` takes a `GPParams` / `KernelParams`
NamedTuple tree of the reference whose leaves are numpy arrays (or anything
`np.asarray` takes) and returns the port's NamedTuples of tensors on
`device`. The classes are matched by name, so nothing of the reference is
imported; this covers every params tree the reference's trainers return
(`GPParams`, `KernelParams` with its per-node `StationaryParams` /
`RQParams` / `LinearParams` / `ScaleParams`, and the baselines'
`SGPRParams` / `SVGPParams`). Artifacts cover the rest of
the serving state (`repro_torch.serve.load_artifact` reads the
reference's files).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import kernels_math, sgpr, svgp

_MODULES = (kernels_math, sgpr, svgp)


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
