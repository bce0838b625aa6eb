"""Ambient-mesh layout points for model internals.

The counterpart of `repro.models.shardctx`. `launch.steps` installs the
mesh (`use_mesh`, a thread-local as in the reference) around a step; the
model calls `shard` / `shard_hidden` / `shard_heads` at the reference's
layout points (residual stream, attention heads, MLP hidden, MoE dispatch
buffers, CE logits). Where the reference hands GSPMD a sharding
constraint, the port redistributes a DTensor to the spec on the mesh's
`DeviceMesh`. With no mesh installed, or on a plain tensor (a run without
DTensor parameters), every helper is the identity, so the model code stays
mesh-agnostic.

A spec entry is "fsdp" -> ("pod", "data"), "tp" -> "model", or None.
GSPMD pads a dim that an axis set does not divide; DTensor shards it
unevenly, which is its own form of the same layout.

`checkpoint` is the model's activation checkpoint, recomputing under the
forward's mesh. `ReplicateOnFailure` runs the few ops DTensor cannot
shard (`REPLICATE_OK`) on replicated operands, for the sharded train step
and the dry run alike.
"""

from __future__ import annotations

import contextlib
import threading

from torch.utils._python_dispatch import TorchDispatchMode

_STATE = threading.local()


def current_mesh():
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    prev = current_mesh()
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = prev


def checkpoint(fn, *args, **kwargs):
    """`torch.utils.checkpoint.checkpoint(fn, *args)` (non-reentrant) whose
    recompute runs under the mesh installed at the forward. The backward
    of CUDA tensors runs on the autograd engine's device thread, which
    does not see this thread's mesh: a recompute there would skip every
    layout point (`local` would hand `fn` DTensors, `shard` would leave
    layouts as they come) and compute other tensors than the forward
    saved. On the CPU the backward runs on the calling thread."""
    from torch.utils.checkpoint import checkpoint as _checkpoint

    mesh = current_mesh()

    def run(*a, **k):
        with use_mesh(mesh):
            return fn(*a, **k)

    return _checkpoint(run, *args, use_reentrant=False, **kwargs)


def _axes(mesh, want):
    if isinstance(want, str):
        want = (want,)
    got = tuple(a for a in want if a in mesh.axis_names)
    if not got:
        return None
    return got if len(got) > 1 else got[0]


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def resolve(mesh, spec) -> tuple:
    """"fsdp" / "tp" / None entries -> mesh axis names (the reference's
    PartitionSpec entries)."""
    out = []
    for s in spec:
        if s == "fsdp":
            out.append(_axes(mesh, ("pod", "data")))
        elif s == "tp":
            out.append(_axes(mesh, "model"))
        else:
            out.append(s)
    return tuple(out)


def shard(x, *spec):
    """Redistribute a DTensor to `spec` under an installed mesh; else x."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    from .sharding import placements

    want = placements(mesh, resolve(mesh, spec), x.ndim)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def gathered(w):
    """A parameter in its compute layout: a DTensor weight stored FSDP x TP
    (`models.sharding`) all-gathered over the fsdp axes, its TP sharding
    kept (ZeRO-3's per-use gather, which the reference leaves to XLA; the
    backward reduce-scatters the gradient back). Identity with no mesh or
    on a plain tensor."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    fsdp = {a for a in ("pod", "data") if a in mesh.axis_names}
    want = [Replicate() if a in fsdp else pl
            for a, pl in zip(mesh.axis_names, w.placements)]
    if list(w.placements) == want:
        return w
    return w.redistribute(w.device_mesh, want)


def axis_size(axis: str) -> int:
    """The installed mesh's size along `axis` (1 with no mesh or axis)."""
    mesh = current_mesh()
    if mesh is None or axis not in mesh.axis_names:
        return 1
    return mesh.axis_size(axis)


def axis_index(axis: str) -> int:
    """This rank's coordinate along `axis` (0 with no mesh or axis)."""
    mesh = current_mesh()
    if mesh is None or axis not in mesh.axis_names:
        return 0
    return mesh.axis_index(axis)


def spec_of(x) -> tuple:
    """A DTensor's layout as a spec (one entry per dim: None, an axis name,
    or a tuple of axis names in mesh order); () for a plain tensor."""
    if not is_dtensor(x):
        return ()
    from torch.distributed.tensor import Shard

    names = x.device_mesh.mesh_dim_names
    out = [[] for _ in range(x.ndim)]
    for a, pl in zip(names, x.placements):
        if isinstance(pl, Shard):
            out[pl.dim].append(a)
    return tuple(None if not e else (e[0] if len(e) == 1 else tuple(e))
                 for e in out)


def local(fn, args: tuple, specs: tuple, out_spec, partial=None):
    """fn(*args) on each rank's local shards: under a mesh with DTensor
    inputs, every tensor argument is redistributed to its spec (None for a
    non-tensor argument), `fn` runs on the local tensors, and its output is
    a DTensor of `out_spec` (one entry per output dim; a list of specs for
    a tuple of outputs). `partial` ({axis: "sum"}, or a list of those per
    output) marks mesh axes over which an output holds partial sums. For a
    region DTensor cannot propagate a layout through (chunked attention on
    head shards, the SSD chunk scan, MoE routing on a batch shard), where
    the reference leaves the partitioning to GSPMD. With no mesh or on
    plain tensors, fn(*args).

    The work is split over the mesh axes on which the outputs are sharded
    or partial (every output must agree on them). An input replicated over
    such an axis gets, on each rank, only the gradient of that rank's part
    of the work, so its gradient is a partial sum over the axis: a
    sequence-split attention's K / V, the weights of a batch-split scan,
    the input of a model-split expert MLP (Megatron's "f" operator)."""
    mesh = current_mesh()
    if mesh is None or not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    from .sharding import placements

    def pl(spec, part=None):
        out = placements(mesh, resolve(mesh, spec), len(spec))
        for axis, op in (part or {}).items():
            if axis in mesh.axis_names:
                out[mesh.axis_names.index(axis)] = Partial(op)
        return tuple(out)

    multi = isinstance(out_spec, list)
    outs = out_spec if multi else [out_spec]
    parts = partial if isinstance(partial, list) else [partial] * len(outs)
    in_pl = tuple(None if s is None else pl(s) for s in specs)
    out_pl = tuple(pl(o, p) for o, p in zip(outs, parts))
    split = {i for o in out_pl for i, p in enumerate(o) if not p.is_replicate()}
    for o in out_pl:
        if any(o[i].is_replicate() for i in split):
            raise ValueError(f"the outputs of a local region disagree on the "
                             f"axes its work is split over: {out_pl}")
    grad_pl = tuple(None if p is None else tuple(
        Partial("sum") if i in split and q.is_replicate() else q
        for i, q in enumerate(p)) for p in in_pl)
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh.device_mesh,
                     redistribute_inputs=True)(*args)


def shard_hidden(h, *, sp: bool = True):
    """Residual stream (B, S, D): batch over fsdp, seq over model (SP)."""
    if h.shape[1] == 1:
        return shard(h, "fsdp", None, None)
    return shard(h, "fsdp", "tp" if sp else None, None)


def shard_heads(x):
    """(B, S, H, hd): heads over model."""
    return shard(x, "fsdp", None, "tp", None)


# the ops that may run on replicated operands when DTensor cannot shard
# them, and why:
#  - a view that splits a model-sharded feature dim into a head count the
#    axis does not divide (smollm's 15 query and 5 KV heads over 16), or
#    that flattens a local shard a redistribute left non-contiguous;
#  - on torch 2.11 (the card's host), the index_put of an embedding row
#    lookup's backward with a batch-sharded index ("Shard dim -1 ... must
#    be normalized"), and the SSD chunk scan's pad and unsqueeze inside
#    `local_map` (placements of one entry on a two-axis mesh); torch 2.13
#    shards all three
REPLICATE_OK = frozenset({
    "aten.view.default", "aten._unsafe_view.default",
    "aten.index_put.default", "aten.constant_pad_nd.default",
    "aten.unsqueeze.default"})


class ReplicateOnFailure(TorchDispatchMode):
    """Runs an op of `REPLICATE_OK` that DTensor cannot shard on replicated
    operands: the op is retried with every DTensor argument redistributed
    to `Replicate`, as GSPMD all-gathers an operand it cannot partition.
    `fallbacks` counts each op that took this path. Any other op that
    fails raises. The sharded train step (`launch.steps`) and the dry run's
    counter (`launch.dryrun`) run under it; nested, the outer mode sees a
    failure first and takes it."""

    def __init__(self):
        super().__init__()
        self.fallbacks: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils._pytree import tree_map

        kwargs = kwargs or {}
        key = str(func)
        if key not in REPLICATE_OK or \
                not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except (RuntimeError, ValueError, IndexError):
            self.fallbacks[key] = self.fallbacks.get(key, 0) + 1

        def rep(x):
            if isinstance(x, DTensor):
                return x.redistribute(x.device_mesh,
                                      [Replicate()] * x.device_mesh.ndim)
            return x

        return func(*tree_map(rep, args), **tree_map(rep, kwargs))
