"""Hyperparameters from the reference's layout into the port's.

`params_from_numpy(tree, device)` takes a `GPParams` / `KernelParams`
NamedTuple tree of the reference whose leaves are numpy arrays (or anything
`np.asarray` takes) and returns the port's NamedTuples of tensors on
`device`. The classes are matched by name, so nothing of the reference is
imported; this covers every params tree the reference's trainer returns
(`GPParams`, and `KernelParams` with its per-node `StationaryParams` /
`RQParams` / `LinearParams` / `ScaleParams`). Artifacts cover the rest of
the serving state (`repro_torch.serve.load_artifact` reads the
reference's files).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import kernels_math


def params_from_numpy(tree, device=None):
    """Reference params tree (numpy leaves) -> the port's, on `device`."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = getattr(kernels_math, type(tree).__name__, None)
        if cls is None or getattr(cls, "_fields", None) != tree._fields:
            raise TypeError(f"no counterpart for {type(tree).__name__}")
        return cls(*(params_from_numpy(v, device) for v in tree))
    if isinstance(tree, tuple):
        return tuple(params_from_numpy(v, device) for v in tree)
    return torch.as_tensor(np.array(tree), device=device)
