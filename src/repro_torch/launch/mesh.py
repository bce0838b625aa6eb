"""Meshes of ranks over a `torch.distributed` process group.

The counterpart of `repro.launch.mesh`. A `Mesh` lays the world's ranks out
row-major over named axes:

  data  — GP kernel-matrix ROW partitions (LM batch axis in the reference)
  model — GP kernel-matrix COLUMN partitions
  pod   — an outer replica axis that folds into the rows

and holds one process subgroup per combination of axes, for the group of
ranks that share this rank's coordinates on every other axis (the row-axis
group of the distributed engine's all-gather, the column-axis group of its
reduce-scatter, the single-axis groups of its ring). `torch.distributed`
requires every rank to create every group in the same order, including the
groups it is not in, so the constructor walks all of them.

`init_distributed(device)` joins the process group once per process: the
card (NCCL) unless `device="cpu"` asks for the CPU (gloo); with no card and
no explicit device it raises. `init_fake_world(world)` joins a `fake`
group instead (`torch.testing`'s FakeStore): one process stands for rank 0
of a world of any size and its collectives move nothing. The dry run counts
a production mesh (`make_production_mesh`, 256 or 512 ranks) on it. `fake`
serves any device type; every other backend still has to match its
device. Under `torchrun` it reads RANK / WORLD_SIZE /
LOCAL_RANK / MASTER_ADDR and binds the process to card LOCAL_RANK before
anything is allocated; a lone process without MASTER_ADDR rendezvouses
through a `file://` store in a fresh temporary directory (no network).
"""

from __future__ import annotations

import itertools
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

AXES = ("pod", "data", "model")


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _serves(backend: str, device: torch.device) -> bool:
    return backend == "fake" or backend == _backend_for(device)


def init_distributed(device=None, *, init_method: str | None = None) -> torch.device:
    """Join (or reuse) the default process group; returns this rank's device.

    device: None = the card (raises without one), "cpu" = gloo on the CPU.
    NCCL serves CUDA tensors and gloo CPU tensors; asking for a device whose
    backend differs from an already-initialized group raises.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dev.index or 0))
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    backend = _backend_for(dev)
    if dist.is_initialized():
        if not _serves(dist.get_backend(), dev):
            raise ValueError(
                f"the process group runs {dist.get_backend()!r}, which does "
                f"not serve {dev.type} tensors (needs {backend!r})")
        return dev
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    if init_method is None:
        if "MASTER_ADDR" in os.environ:
            init_method = "env://"
        elif world == 1:
            # a fresh path; the file store removes its file when the group ends
            fd, store = tempfile.mkstemp(prefix="repro_torch_pg_")
            os.close(fd)
            os.unlink(store)
            init_method = f"file://{store}"
        else:
            raise ValueError(
                f"WORLD_SIZE={world} needs MASTER_ADDR/MASTER_PORT (torchrun "
                f"sets them) or an explicit init_method")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return dev


class Mesh:
    """Row-major layout of the world's ranks over named axes, with the
    subgroups of every axis combination (see the module docstring).

    shape / axis_names / devices.shape follow the reference's mesh, so
    `mesh_axis_sizes` and the engine's geometry read either.
    """

    def __init__(self, shape: tuple, axis_names: tuple, *, device: torch.device):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} does not match axes {axis_names}")
        unknown = set(axis_names) - set(AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {unknown}; use {AXES}")
        if [a for a in AXES if a in axis_names] != list(axis_names):
            raise ValueError(f"mesh axes must be in the order {AXES}")
        world = dist.get_world_size()
        if int(np.prod(shape)) != world:
            raise ValueError(f"mesh {shape} needs {int(np.prod(shape))} ranks, "
                             f"the world has {world}")
        self.shape = shape
        self.axis_names = axis_names
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        if not _serves(self.backend, self.device):
            raise ValueError(f"a {self.backend!r} group cannot serve "
                             f"{self.device.type} tensors")
        self.rank = dist.get_rank()
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank, shape))
        self.devices = np.arange(world).reshape(shape)  # ranks, as the reference's devices
        self._groups: dict[tuple, tuple] = {}
        k = len(shape)
        for mask in range(1, 1 << k):
            axes = tuple(axis_names[j] for j in range(k) if mask >> j & 1)
            others = [j for j in range(k) if not mask >> j & 1]
            for fixed in itertools.product(*(range(shape[j]) for j in others)):
                sel = [slice(None)] * k
                for j, c in zip(others, fixed):
                    sel[j] = c
                ranks = sorted(int(r) for r in self.devices[tuple(sel)].reshape(-1))
                group = (dist.group.WORLD if len(ranks) == world
                         else dist.new_group(ranks))
                if self.rank in ranks:
                    self._groups[axes] = (group, ranks)

    @property
    def device_mesh(self):
        """The `torch.distributed.DeviceMesh` of the same layout (built on
        first use), on which DTensors are placed."""
        if getattr(self, "_device_mesh", None) is None:
            from torch._subclasses.fake_tensor import unset_fake_temporarily
            from torch.distributed.device_mesh import DeviceMesh

            with unset_fake_temporarily():   # its rank table is real
                self._device_mesh = DeviceMesh(self.device.type, self.devices,
                                               mesh_dim_names=self.axis_names)
        return self._device_mesh

    def _key(self, axes) -> tuple:
        axes = tuple(a for a in self.axis_names if a in tuple(axes))
        if not axes:
            raise ValueError("no mesh axes given")
        return axes

    def group(self, axes):
        """This rank's process group over `axes` (any order)."""
        return self._groups[self._key(axes)][0]

    def group_ranks(self, axes) -> list[int]:
        """Global ranks of this rank's group over `axes`, in the row-major
        order of those axes (the order of a tiled all-gather)."""
        return self._groups[self._key(axes)][1]

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def shifted_rank(self, axis: str, shift: int) -> int:
        """Global rank of the neighbour `shift` steps along `axis` (cyclic)."""
        j = self.axis_names.index(axis)
        coords = list(self.coords)
        coords[j] = (coords[j] + shift) % self.shape[j]
        return int(self.devices[tuple(coords)])

    def __repr__(self):
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, rank "
                f"{self.rank}, {self.backend} on {self.device})")


def make_mesh(shape: tuple, axis_names: tuple, *, device=None) -> Mesh:
    """A mesh over the (joined on demand) default process group."""
    dev = init_distributed(device)
    return Mesh(shape, axis_names, device=dev)


def init_fake_world(world: int, rank: int = 0) -> None:
    """Join a `fake` process group of `world` ranks as `rank` (one process,
    no peers; the dry run's stand-in for a production cluster). Leaves an
    already-initialized fake group of that size as it is."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != world:
            raise ValueError(
                f"a {dist.get_backend()!r} group of world "
                f"{dist.get_world_size()} is already initialized")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh: (16, 16) ("data", "model"), or (2, 16, 16)
    ("pod", "data", "model") with `multi_pod`, over a process group of 256
    or 512 ranks (a `fake` one, joined here, unless one of that size is
    already initialized). Its tensors are CPU ones: the dry run counts on
    fake CPU tensors (see `launch.dryrun`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = int(np.prod(shape))
    if not (dist.is_initialized() and dist.get_world_size() == world):
        init_fake_world(world)
    return Mesh(shape, axes, device=torch.device("cpu"))


def make_host_mesh(data: int | None = None, model: int = 1, *,
                   device=None) -> Mesh:
    """(data, model) mesh over every rank of the world (tests / local runs)."""
    dev = init_distributed(device)
    n = dist.get_world_size()
    if data is None:
        data = n // model
    return Mesh((data, model), ("data", "model"), device=dev)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def data_axes(mesh) -> tuple[str, ...]:
    """All batch-parallel axes present in the mesh (pod folds into data)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
