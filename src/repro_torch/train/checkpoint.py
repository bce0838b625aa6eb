"""Atomic, integrity-checked checkpoints — the reference's on-disk layout.

    <dir>/step_<k>/arrays.npz        flat {path: np.ndarray}
    <dir>/step_<k>/MANIFEST.json     shapes/dtypes/crc32 per array + meta
    <dir>/step_<k>/.COMPLETE         written last; restore requires it

Writes go to `step_<k>.tmp/` and are renamed into place, so a preempted
writer never corrupts the latest complete checkpoint. The npz keys are the
reference's `jax.tree_util.keystr` paths — ``['params'].raw_noise``,
``['params'].nodes[0].raw_outputscale``, ``['X']`` — over a tree of dicts
(keys sorted, as jax flattens them), NamedTuples (field order) and tuples,
so that each package reads the other's files. `CheckpointManager` saves
every k steps, keeps the newest K complete checkpoints and resumes from the
latest, as the reference's.

A tree with DTensor leaves (a state sharded over a mesh) is saved by every
rank of the world together: each rank gathers every leaf's full array, in
the same order, rank 0 alone writes the files (and runs the retention),
and a barrier follows before any rank goes on. The files are the one-rank
layout, so a checkpoint of any mesh restores onto any other.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any

import numpy as np
import torch


def tree_map_with_keys(fn, tree: Any, prefix: str = ""):
    """Rebuild `tree` with every leaf replaced by fn(keystr, leaf), walking
    it in jax's flatten order."""
    if isinstance(tree, dict):
        return {k: tree_map_with_keys(fn, tree[k], f"{prefix}[{k!r}]")
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_keys(fn, v, f"{prefix}.{f}")
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_keys(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def flatten_with_keys(tree: Any) -> list[tuple[str, Any]]:
    """[(keystr, leaf)] in jax's flatten order."""
    out: list = []
    tree_map_with_keys(lambda k, leaf: out.append((k, leaf)), tree)
    return out


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _sharded(tree) -> bool:
    """True if a leaf of `tree` is a DTensor: saving it is collective."""
    return any(_is_dtensor(v) for _, v in flatten_with_keys(tree))


def _writes(sharded: bool) -> bool:
    """This process writes: always for a plain tree, else rank 0 only."""
    import torch.distributed as dist

    return not sharded or not dist.is_initialized() or dist.get_rank() == 0


def to_numpy(leaf) -> np.ndarray:
    """A leaf as a numpy array; bf16 (which numpy lacks) as its raw uint16
    bits, which `from_numpy` turns back into bf16 bit for bit. A DTensor
    gives its full array (a gather: every rank of its mesh calls this)."""
    if isinstance(leaf, torch.Tensor):
        if _is_dtensor(leaf):
            leaf = leaf.full_tensor()
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy()
    return np.asarray(leaf)


def from_numpy(arr: np.ndarray, like):
    """A restored array as a leaf like `like`: a tensor of its dtype on its
    device (bf16 from the uint16 bits `to_numpy` wrote; the full tensor
    for a DTensor template, which the caller places); any other template
    leaf gets the array itself."""
    if not isinstance(like, torch.Tensor):
        return arr
    if like.dtype == torch.bfloat16 and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr)).to(like.dtype)
    return t.to(like.device)


def tree_from_numpy(template: Any, arrays: Any):
    """`arrays` (a tree shaped as `template`, as `load_checkpoint` returns
    it) with every leaf made like the template's (`from_numpy`)."""
    by_key = dict(flatten_with_keys(arrays))
    return tree_map_with_keys(lambda k, leaf: from_numpy(by_key[k], leaf),
                              template)


def save_checkpoint(directory: str, step: int, tree: Any,
                    meta: dict | None = None) -> str:
    """Atomically write `tree` (nested dicts/NamedTuples of tensors) at
    `step`. A tree with DTensor leaves is saved collectively (see the
    module docstring): every rank calls this, rank 0 writes."""
    final = os.path.join(directory, f"step_{step:08d}")
    sharded = _sharded(tree)
    arrays = {k: to_numpy(v) for k, v in flatten_with_keys(tree)}
    if _writes(sharded):
        _write(final, step, arrays, meta)
    if sharded:
        import torch.distributed as dist

        dist.barrier()
    return final


def _write(final: str, step: int, arrays: dict, meta: dict | None) -> None:
    os.makedirs(os.path.dirname(final), exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "meta": meta or {},
        "arrays": {
            k: {"shape": list(v.shape), "dtype": str(v.dtype),
                "crc32": zlib.crc32(np.ascontiguousarray(v).tobytes())}
            for k, v in arrays.items()
        },
    }
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    with open(os.path.join(tmp, ".COMPLETE"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def _complete_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, ".COMPLETE")):
                steps.append(int(name.split("_")[1]))
    return sorted(steps)


def load_checkpoint(directory: str, template: Any, step: int | None = None,
                    *, verify: bool = True) -> tuple[Any, int, dict]:
    """Restore numpy arrays into the structure of `template`; returns
    (tree, step, meta). Values come back exactly as saved."""
    steps = _complete_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no complete checkpoint under {directory}")
    step = steps[-1] if step is None else step
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}

    if verify:
        for k, info in manifest["arrays"].items():
            if zlib.crc32(np.ascontiguousarray(arrays[k]).tobytes()) != info["crc32"]:
                raise IOError(f"checkpoint corruption in {k}: crc mismatch")
            if list(arrays[k].shape) != info["shape"]:
                raise IOError(f"checkpoint corruption in {k}: shape mismatch")

    def restore(key, tmpl_leaf):
        if key not in arrays:
            raise KeyError(f"checkpoint missing array {key}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(np.shape(tmpl_leaf)):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != template "
                             f"{np.shape(tmpl_leaf)}")
        return arr

    return tree_map_with_keys(restore, template), step, manifest["meta"]


class CheckpointManager:
    """save-every-k + retention + auto-resume convenience wrapper."""

    def __init__(self, directory: str, *, save_every: int = 100, keep: int = 3):
        self.directory = directory
        self.save_every = save_every
        self.keep = keep

    def maybe_save(self, step: int, tree: Any, meta: dict | None = None,
                   force: bool = False) -> str | None:
        if not force and (step % self.save_every != 0):
            return None
        path = save_checkpoint(self.directory, step, tree, meta)
        if _writes(_sharded(tree)):
            self._retain()
        return path

    def restore_or_init(self, template: Any) -> tuple[Any, int, dict]:
        """Resume from the latest complete checkpoint, else (template, 0, {})."""
        try:
            return load_checkpoint(self.directory, template)
        except FileNotFoundError:
            return template, 0, {}

    def _retain(self):
        steps = _complete_steps(self.directory)
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def latest_step(self) -> int | None:
        steps = _complete_steps(self.directory)
        return steps[-1] if steps else None
