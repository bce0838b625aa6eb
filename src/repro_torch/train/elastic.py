"""Elastic rescale: restore a run onto a different mesh factorization.

The counterpart of `repro.train.elastic`. Checkpoints are host-canonical
(full logical arrays, no shard layout baked in; see `train.checkpoint`), so
elasticity is purely a placement concern: load on every rank, then place
each array as a DTensor laid out by a spec on the NEW mesh's `DeviceMesh`.
Each rank keeps its own shard of its full copy; nothing is communicated.
A dp = 4 run restores onto dp = 2 (or another pod count) bitwise.

Paths are the checkpoint's keystr paths (`['params']['w']`), and a spec is
a tuple of axis names / tuples / None per dim, as in `models.sharding`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .checkpoint import flatten_with_keys, tree_map_with_keys


def reshard(tree, mesh, pspec_fn=None):
    """Place a host-canonical tree (numpy arrays or tensors) onto `mesh`
    (a `launch.mesh.Mesh`) as DTensors on its device.

    pspec_fn: (keystr path, leaf) -> spec; the default replicates
    everything (right for GP hyperparameters and small states; LM
    parameter specs come from `repro_torch.models.sharding.param_pspec`).
    """
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.sharding import placements

    def place(path, leaf):
        t = torch.as_tensor(np.asarray(leaf) if not isinstance(leaf, torch.Tensor)
                            else leaf).to(mesh.device)
        spec = pspec_fn(path, leaf) if pspec_fn is not None else ()
        return distribute_tensor(t, mesh.device_mesh,
                                 placements(mesh, spec, t.ndim),
                                 src_data_rank=None)

    return tree_map_with_keys(place, tree)


def validate_divisibility(tree, mesh, pspec_fn) -> list[str]:
    """Pre-flight check for a target mesh: every sharded axis must divide
    its dim. Returns the problems (empty = the mesh is compatible), worded
    as the reference's."""
    sizes = dict(zip(mesh.axis_names, tuple(mesh.devices.shape)))
    problems = []
    for path, leaf in flatten_with_keys(tree):
        spec = pspec_fn(path, leaf)
        shape = tuple(np.shape(leaf))
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            axes = (axes,) if isinstance(axes, str) else tuple(axes)
            total = int(math.prod(sizes[a] for a in axes))
            if shape[dim] % total:
                problems.append(
                    f"{path} dim {dim} ({shape[dim]}) % mesh{axes} "
                    f"({total}) != 0")
    return problems
