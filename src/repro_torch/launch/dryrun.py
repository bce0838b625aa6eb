"""Multi-pod dry run: count every (arch x shape x mesh) cell per device,
with nothing allocated, and price it on the H100 roofline.

The counterpart of `repro.launch.dryrun`, with the same CLI, cells, JSON
keys and status handling. Where the reference lowers and compiles each
cell for 512 placeholder XLA devices and reads `cost_analysis` /
`memory_analysis`, the port counts the cell's step as it runs eagerly:

  * the mesh is `make_production_mesh` over a `fake` process group of 256
    (or 512) ranks; this process is rank 0 and its collectives move nothing;
  * tensors are fake (`FakeTensorMode`): shapes, dtypes and devices only;
    LM parameters are DTensors on the mesh's `DeviceMesh`, laid out by
    `models.sharding.param_placements`, and the batch / caches by the
    reference's batch and cache specs;
  * one step runs under `OpCounter`, a `TorchDispatchMode` that sees the
    LOCAL ops DTensor dispatches on rank 0's shards (it declines the
    DTensor-level op, and skips DTensor's own sharding propagation, which
    runs each new op once on global shapes), so every count is per device,
    as the reference's SPMD `cost_analysis` is:
      - FLOPs from `torch.utils.flop_counter`'s formulas,
      - bytes as every op's operands plus outputs (views and allocations
        excepted), XLA's own definition of bytes accessed,
      - transcendentals as the output elements of exp / log / tanh /
        sigmoid / rsqrt / erf / softmax and the like,
      - collectives as (kind, result bytes, group size) per call, priced by
        `roofline.collective_stats`; `CommDebugMode` counts the same calls
        and the two counts are held equal;
  * memory: argument and output bytes are the local bytes of the step's
    inputs and results; temp bytes the peak of the storages the step
    allocated and held at once, followed through weak references (fake
    storages are tracked as real ones; `MemTracker` does the same but
    hooks the modules' parameters, which the steps rebind per use).

Depth: each cell is counted at depth 1 and 2 (layers for the LM, CG
iterations for the GP cells) and extrapolated, total = A + (depth - 1) *
(B - A), as the reference does (`_two_pass` / `_extrapolate`,
`raw_pass_a` / `raw_pass_b`). In eager mode every layer runs the same ops,
so the extrapolation equals a full-depth count.

The GP cells count the `partitioned` backend: the fused CUDA kernels take
raw device pointers and cannot run on fake tensors, so `--gp-backend
pallas` is refused, as the reference refuses it off-TPU. They run a fixed
CG trip count (the reference's `train_cg_iters` / `pred_cg_iters`), and the
train cell's SLQ probes are passed in (an empty tensor of the probes'
shape) rather than drawn, since the draw reads a seed on the host.

The fake tensors are CPU tensors: the counted ops (the model's and the
engine's, shapes, dtypes and collectives) are the same as for CUDA ones,
and fake CUDA DTensors fail where fake CPU ones run. A CPU-only build of
PyTorch cannot redistribute them; on the card's build (torch 2.11) the
train cells' activation checkpoints recompute a different sequence of fake
CUDA tensors than their forward saved (measured on one H100).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m
    PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --cells train_4k,decode_32k
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch import roofline as rl
from repro_torch.launch.specs import (
    SHAPES, Cell, cell_for, decode_specs, gp_cells, input_specs,
)
from repro_torch.models import get_arch, list_archs
from repro_torch.models.shardctx import REPLICATE_OK, ReplicateOnFailure  # noqa: F401

LM_ARCHS = tuple(a for a in list_archs() if a != "gp-exact-1m")
DEFAULT_OUT = "experiments/dryrun_torch"

# ops whose outputs are views or fresh allocations: no bytes move
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "_local_scalar_dense", "device", "sym_size", "sym_stride",
             "sym_numel", "sym_storage_offset", "wait_tensor"}
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "log10",
                   "tanh", "sigmoid", "rsqrt", "sqrt", "erf", "erfc", "sin",
                   "cos", "pow", "_softmax", "_log_softmax", "logsumexp",
                   "silu", "silu_backward", "gelu", "gelu_backward",
                   "softplus", "softplus_backward"}
# collective op -> (kind, which tensor is the result: "out" or arg index)
_COLLECTIVE = {
    "_c10d_functional::all_reduce": ("all-reduce", "out"),
    "_c10d_functional::all_reduce_": ("all-reduce", 0),
    "c10d::allreduce_": ("all-reduce", 0),
    "_c10d_functional::all_gather_into_tensor": ("all-gather", "out"),
    "c10d::_allgather_base_": ("all-gather", 0),
    "c10d::allgather_": ("all-gather", 0),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", "out"),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 0),
    "c10d::reduce_scatter_": ("reduce-scatter", 0),
    "_c10d_functional::all_to_all_single": ("all-to-all", "out"),
    "c10d::alltoall_base_": ("all-to-all", 0),
    "c10d::send": ("collective-permute", 0),
}
_NOT_COUNTED = {"_c10d_functional::wait_tensor", "c10d::recv_",
                "c10d::barrier", "c10d::monitored_barrier_"}


def _tensors(x) -> list:
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _group_size(name: str, args) -> int:
    from torch.distributed import distributed_c10d as c10d

    if name.startswith("_c10d_functional::"):
        return c10d._resolve_process_group(args[-1]).size()  # the group name
    for a in args:
        if isinstance(a, torch.ScriptObject):
            return int(torch.distributed.ProcessGroup.unbox(a).size())
        if isinstance(a, torch.distributed.ProcessGroup):
            return int(a.size())
    raise ValueError(f"{name} without a process group")


_PROPAGATING = threading.local()


def _mark_propagation():
    """Wrap DTensor's sharding propagation, which runs each new op schema
    once on global shapes (under whatever fake mode is active), so the
    counters can skip what it dispatches. Installed once."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    inner = ShardingPropagator._propagate_tensor_meta_non_cached
    if getattr(inner, "_marks_propagation", False):
        return

    def wrapped(self, *args, **kwargs):
        _PROPAGATING.depth = getattr(_PROPAGATING, "depth", 0) + 1
        try:
            return inner(self, *args, **kwargs)
        finally:
            _PROPAGATING.depth -= 1

    wrapped._marks_propagation = True
    ShardingPropagator._propagate_tensor_meta_non_cached = wrapped


class OpCounter(TorchDispatchMode):
    """Counts the local ops of a step: flops, bytes, transcendentals and
    collective records, per device (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.collectives: list = []
        self.live = 0        # bytes of storages allocated here, still held
        self.peak = 0
        self._refs: dict = {}
        self._known: set = set()

    def known(self, tensors):
        """Storages that exist before the step (its arguments): an op that
        returns a view of one (a `detach`) allocates nothing."""
        from torch.distributed._tools.common_utils import get_untyped_storages

        for t in tensors:
            self._known.update(id(st) for st in get_untyped_storages(t))

    def _hold(self, t):
        from torch.distributed._tools.common_utils import get_untyped_storages

        for st in get_untyped_storages(t):
            key = id(st)
            if key in self._refs or key in self._known:
                continue
            n = st.nbytes()

            def free(_, key=key, n=n):
                self._refs.pop(key, None)
                self.live -= n
            self._refs[key] = weakref.ref(st, free)
            self.live += n
            self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # let DTensor run its local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # not DTensor's sharding propagation (a thread-local: the autograd
        # engine runs a card's backward on a thread of its own)
        if not getattr(_PROPAGATING, "depth", 0):
            self._count(func, args, kwargs, out)
            for t in _tensors(out):
                self._hold(t)
        return out

    def _count(self, func, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry

        name = func.name().split(".")[0]
        if name in _COLLECTIVE:
            kind, which = _COLLECTIVE[name]
            res = out if which == "out" else args[which]
            self.collectives.append((kind, _nbytes(_tensors(res)),
                                     _group_size(name, args)))
            return
        if name in _NOT_COUNTED:
            return
        if name.split("::")[0] in ("c10d", "_c10d_functional"):
            raise ValueError(f"the dry run does not price {name}")
        pk = func._overloadpacket
        if pk in flop_registry:
            self.flops += int(flop_registry[pk](*args, **kwargs, out_val=out))
        base = name.split("::")[-1]
        if base in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in _tensors(out))
        if func.is_view or base in _NO_BYTES:
            return
        self.bytes += _nbytes(_tensors((args, kwargs))) + _nbytes(_tensors(out))


class _NoModuleTracker:
    """A module tracker for `CommDebugMode` that installs no module hooks
    and files every count under "Global". Its own tracker keys the
    per-module hook handles by module name, so a module that runs twice in
    one forward (an activation checkpoint reruns it) keeps a stale hook
    after the mode exits, which breaks the next plain forward."""

    name = "Global"
    is_bw = False
    activation_checkpointing = False

    def __init__(self):
        self.module_parents_dict = {"Global": set()}
        self.module_helper_dict: dict = {}
        self.parent_dict: dict = {}
        self.module_parameters_dict: dict = {}
        self.sharding_dict: dict = {}

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return None


def comm_debug_mode():
    """`CommDebugMode` counting collectives, without module tracking."""
    from torch.distributed.tensor.debug import CommDebugMode

    mode = CommDebugMode()
    mode.advanced_module_tracker = _NoModuleTracker()
    return mode


_KIND_BY_BASE = {k.split("::")[1]: v[0] for k, v in _COLLECTIVE.items()}


def comm_kind_counts(comm_mode) -> dict:
    """`CommDebugMode`'s per-op counts by the reference's collective kinds."""
    out = {k: 0 for k in rl.COLLECTIVES}
    for op, n in comm_mode.get_comm_counts().items():
        kind = _KIND_BY_BASE.get(str(op).rsplit(".", 1)[-1])
        if kind is not None:
            out[kind] += n
    return out


def count_step(run, *, external=()) -> dict:
    """Run `run()` once under the counters; {flops, bytes,
    transcendentals, coll, comm_counts, memory, fallbacks}. `external`
    are the step's argument tensors (their local bytes are the argument
    bytes)."""
    _mark_propagation()
    counter = OpCounter()
    counter.known(_local(_tensors(external)))
    fallback = ReplicateOnFailure()
    with comm_debug_mode() as comm, counter, fallback:
        out = run()
    arg_bytes = _local_bytes(_tensors(external))
    out_bytes = _local_bytes(_tensors(out))
    return {
        "flops": float(counter.flops),
        "bytes": float(counter.bytes),
        "transcendentals": float(counter.transcendentals),
        "coll": rl.collective_stats(counter.collectives),
        "comm_counts": comm_kind_counts(comm),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": int(counter.peak),
                   "generated_code_bytes": 0},
        "fallbacks": fallback.fallbacks,
    }


def _local(ts) -> list:
    from torch.distributed.tensor import DTensor

    return [t.to_local() if isinstance(t, DTensor) else t for t in ts]


def _local_bytes(ts) -> int:
    return _nbytes(_local(ts))


def _extrapolate(a: dict, b: dict, depth: int) -> dict:
    """total = A + (depth - 1) * max(B - A, 0), per counter and per memory
    term (each layer adds its parameters, moments, caches and saved
    activations)."""
    def ext(x, y):
        return x + (depth - 1) * max(y - x, 0.0)

    coll = {k: ext(a["coll"][k], b["coll"][k])
            for k in a["coll"] if k not in ("counts",)}
    coll["counts"] = {kk: int(ext(a["coll"]["counts"][kk],
                                  b["coll"]["counts"][kk]))
                      for kk in a["coll"]["counts"]}
    return {
        "flops": ext(a["flops"], b["flops"]),
        "bytes": ext(a["bytes"], b["bytes"]),
        "transcendentals": ext(a["transcendentals"], b["transcendentals"]),
        "coll": coll,
        "memory": {k: int(ext(a["memory"][k], b["memory"][k]))
                   for k in a["memory"]},
    }


def _two_pass(count_at, cfg, cell, n_devices: int, depth: int) -> dict:
    """count_at(d) counts the cell at depth d; passes at d = 1 and 2."""
    t0 = time.time()
    raw_a = count_at(1)
    raw_b = count_at(2)
    for raw in (raw_a, raw_b):
        if raw["comm_counts"] != raw["coll"]["counts"]:
            raise AssertionError(
                f"CommDebugMode counted {raw['comm_counts']}, the counter "
                f"{raw['coll']['counts']}")
    total = _extrapolate(raw_a, raw_b, depth)
    cost = {"flops": total["flops"], "bytes accessed": total["bytes"],
            "transcendentals": total["transcendentals"]}
    mf = rl.model_flops_for(cfg, cell)
    # GP cells: charge the operator's matmul dtype (fp32 default, bf16 on
    # the mixed-precision path); LM cells train in bf16
    cdt = getattr(cfg, "compute_dtype", "bf16") or "float32"
    roof = rl.analyze(cost, total["coll"], mf, n_devices, compute_dtype=cdt)
    return {
        "cost": cost,
        "collectives": total["coll"],
        "memory": total["memory"],
        "fallbacks": raw_b["fallbacks"],
        "roofline": roof._asdict(),
        "raw_pass_a": {k: raw_a[k] for k in ("flops", "bytes")},
        "raw_pass_b": {k: raw_b[k] for k in ("flops", "bytes")},
        "depth": depth,
        "compile_s": round(time.time() - t0, 1),
    }


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _fake_collectives():
    """Register fake-tensor rules for the c10d collectives (the GP engine
    calls them on plain tensors), where this torch keeps them."""
    import importlib.util

    name = "torch.distributed._tools.fake_collectives"
    if importlib.util.find_spec(name) is not None:
        importlib.import_module(name)


def _at_depth(cfg, d: int):
    if cfg.is_encdec:
        return cfg._replace(n_layers=d, n_enc_layers=d)
    return cfg._replace(n_layers=d)


def _place(mesh, t, spec):
    """A full fake tensor -> a DTensor laid out by `spec` (rank 0 keeps its
    shard; nothing is communicated)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.sharding import placements

    return distribute_tensor(t, mesh.device_mesh,
                             placements(mesh, spec, t.ndim), src_data_rank=None)


def _place_tree(mesh, tree, specs):
    if isinstance(tree, dict):
        return {k: _place_tree(mesh, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_place_tree(mesh, v, s) for v, s in zip(tree, specs)]
    if isinstance(tree, torch.Tensor):
        return _place(mesh, tree, specs)
    return tree


def count_lm_cell(cfg, cell: Cell, mesh, depth: int, *, lr=3e-4) -> dict:
    """Counts of one step of `cell` on `mesh` for `cfg` cut to `depth`
    layers (the encoder's too)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    _fake_collectives()
    from repro_torch.launch.steps import (
        TrainState, make_decode_step, make_prefill_step, make_train_step,
    )
    from repro_torch.models import init_params
    from repro_torch.models.sharding import (
        batch_shardings, decode_state_shardings, distribute_lm, token_sharding,
    )

    cfg = _at_depth(cfg, depth)
    dev = mesh.device
    with FakeTensorMode(allow_non_fake_inputs=True):
        lm = distribute_lm(mesh, init_params(cfg, device="meta"))
        if cell.kind in ("train", "prefill"):
            batch = input_specs(cfg, cell, device=dev)
            batch = _place_tree(mesh, batch, batch_shardings(mesh, batch))
        if cell.kind in ("prefill", "decode"):
            state, tok = decode_specs(cfg, cell, device=dev)
            state = _place_tree(mesh, state, decode_state_shardings(mesh, state))
        if cell.kind == "train":
            params = {k: p.detach() for k, p in lm.named_parameters()}
            mu = {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()}
            st = TrainState(params, mu, {k: v.clone() for k, v in mu.items()},
                            torch.zeros((), dtype=torch.int32, device=dev))
            step = make_train_step(cfg, mesh, lr=lr)

            def run():
                return step(st, batch)
            ext = (st, batch)
        elif cell.kind == "prefill":
            step = make_prefill_step(cfg, mesh)

            def run():
                return step(lm, state, batch)
            ext = (list(lm.parameters()), state, batch)
        elif cell.kind == "decode":
            # the new token at the last slot: it attends to the whole
            # cache of seq_len, as the reference's masked decode reads it
            state["t"] = cell.seq - 1
            tok = _place(mesh, tok, token_sharding(mesh, cell.batch))
            step = make_decode_step(cfg, mesh)

            def run():
                return step(lm, state, tok)
            ext = (list(lm.parameters()), state, tok)
        else:
            raise ValueError(cell.kind)
        with implicit_replication():
            return count_step(run, external=ext)


def run_lm_cell(arch_id: str, shape_name: str, mesh, *, lr=3e-4,
                overrides: dict | None = None, cfg=None, cell=None) -> dict:
    """One LM cell's JSON record. `cfg` / `cell` replace the registry's
    config and the shape's cell (tests count small ones)."""
    cfg = cfg if cfg is not None else get_arch(arch_id)
    if overrides:
        cfg = cfg._replace(**overrides)
    cell = cell if cell is not None else cell_for(cfg, shape_name)
    if cell.skip:
        return {"cell": cell._asdict(), "status": "skipped", "reason": cell.skip}
    n_devices = int(mesh.devices.size)
    res = _two_pass(lambda d: count_lm_cell(cfg, cell, mesh, d, lr=lr),
                    cfg, cell, n_devices, cfg.n_layers)
    res.update({"cell": cell._asdict(), "status": "ok",
                "n_devices": n_devices})
    return res


# ---------------------------------------------------------------------------
# GP cells
# ---------------------------------------------------------------------------


def count_gp_cell(GP, kind: str, mesh, depth: int, *,
                  pcg_method="standard") -> dict:
    """Counts of one GP train step (`train_cg_iters = depth`) or one
    mean-cache solve (`pred_cg_iters = depth`) on `mesh`, fixed trips."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    _fake_collectives()
    from repro_torch.core.kernels_math import init_params as gp_init
    from repro_torch.core.kernels_math import params_map
    from repro_torch.launch.steps import make_gp_predict_setup, make_gp_train_step

    dev = mesh.device
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = params_map(lambda a: torch.empty(a.shape, dtype=a.dtype,
                                                  device=dev),
                            gp_init(noise=0.5, device="meta"))
        X = torch.empty((GP.n, GP.d), dtype=torch.float32, device=dev)
        if kind == "gp_train":
            step, geom = make_gp_train_step(
                GP._replace(train_cg_iters=depth), mesh,
                pcg_method=pcg_method, fixed_iters=True)
            y = torch.empty((geom.n_local,), dtype=torch.float32, device=dev)
            probes = torch.empty((geom.n_local, GP.num_probes),
                                 dtype=torch.float32, device=dev)
            mu = params_map(lambda a: torch.zeros_like(a), params)
            nu = params_map(lambda a: torch.zeros_like(a), params)
            stepc = torch.zeros((), dtype=torch.int32, device=dev)

            def run():
                return step(X, y, params, mu, nu, stepc, None, probes)
            ext = (X, y, params, mu, nu, stepc, probes)
        else:
            solve, geom = make_gp_predict_setup(
                GP._replace(pred_cg_iters=depth), mesh, fixed_iters=True)
            y = torch.empty((geom.n_local,), dtype=torch.float32, device=dev)

            def run():
                return solve(X, y, params)
            ext = (X, y, params)
        return count_step(run, external=ext)


def run_gp_cell(kind: str, mesh, pcg_method="standard", mode=None,
                backend=None, compute_dtype=None, overlap=False,
                gp_cfg=None) -> dict:
    from repro_torch.configs.gp_exact_1m import CONFIG

    GP = gp_cfg if gp_cfg is not None else CONFIG
    if mode is not None:
        GP = GP._replace(mode=mode)
    if overlap:
        GP = GP._replace(overlap=True)
    if backend == "pallas":
        # the fused CUDA kernels take raw device pointers (ctypes) and
        # cannot run on fake tensors; count them on the card instead
        raise ValueError(
            "--gp-backend pallas cannot be counted on fake tensors: the "
            "fused kernels read device pointers; the dry run counts "
            "'partitioned' (see repro_torch.kernels.kmvm)")
    if backend is not None:
        GP = GP._replace(backend=backend)
    if compute_dtype is not None:
        GP = GP._replace(compute_dtype=compute_dtype)
    cell = [c for c in gp_cells(GP) if c.kind == kind][0]
    n_devices = int(mesh.devices.size)
    depth = GP.train_cg_iters if kind == "gp_train" else GP.pred_cg_iters
    res = _two_pass(lambda d: count_gp_cell(GP, kind, mesh, d,
                                            pcg_method=pcg_method),
                    GP, cell, n_devices, depth)
    res.update({"cell": cell._asdict(), "status": "ok",
                "n_devices": n_devices, "gp_mode": GP.mode,
                "pcg_method": pcg_method, "gp_backend": GP.backend,
                "gp_overlap": GP.overlap,
                "gp_compute_dtype": GP.compute_dtype or "float32"})
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id, comma list, or 'all'")
    ap.add_argument("--cells", default="all",
                    help="shape names, comma list, or 'all'")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2x16x16 (pod,data,model) mesh")
    ap.add_argument("--gp-mode", default=None, choices=("1d", "2d"))
    ap.add_argument("--pcg-method", default="standard",
                    choices=("standard", "pipelined"))
    ap.add_argument("--gp-backend", default=None,
                    choices=("partitioned", "pallas"))
    ap.add_argument("--gp-dtype", default=None, choices=("bfloat16",))
    ap.add_argument("--gp-overlap", action="store_true",
                    help="ring-pipelined chunked contraction (overlap the "
                         "gather with tile compute)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--tag", default="", help="suffix for output filenames")
    ap.add_argument("--override", default="",
                    help="ArchConfig overrides, e.g. 'remat=False,ce_chunk=1024'")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in filter(None, args.override.split(",")):
        k, v = kv.split("=")
        overrides[k] = eval(v)  # ints/bools/tuples from trusted CLI

    from repro_torch.launch.mesh import make_production_mesh

    t0 = time.time()
    mesh = make_production_mesh(multi_pod=args.multi_pod)
    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    print(f"[dryrun] mesh {mesh_name}: {mesh.devices.size} devices "
          f"{dict(zip(mesh.axis_names, mesh.devices.shape))} (fake group, "
          f"cpu tensors, {time.time() - t0:.1f}s)", flush=True)
    os.makedirs(args.out, exist_ok=True)

    archs = LM_ARCHS if args.arch == "all" else tuple(args.arch.split(","))
    if args.arch == "all":
        archs = archs + ("gp-exact-1m",)
    shapes = tuple(SHAPES) if args.cells == "all" else tuple(args.cells.split(","))

    results = []
    for arch in archs:
        if arch == "gp-exact-1m":
            for kind in ("gp_train", "gp_predict"):
                tag = f"{arch}__{kind}__{mesh_name}{args.tag}"
                try:
                    r = run_gp_cell(kind, mesh, pcg_method=args.pcg_method,
                                    mode=args.gp_mode,
                                    backend=args.gp_backend,
                                    compute_dtype=args.gp_dtype,
                                    overlap=args.gp_overlap)
                except Exception:
                    r = {"cell": {"arch": arch, "shape": kind}, "status": "error",
                         "traceback": traceback.format_exc()}
                r["mesh"] = mesh_name
                _dump(args.out, tag, r)
                results.append(r)
            continue
        for shape in shapes:
            tag = f"{arch}__{shape}__{mesh_name}{args.tag}"
            try:
                r = run_lm_cell(arch, shape, mesh, overrides=overrides)
            except Exception:
                r = {"cell": {"arch": arch, "shape": shape}, "status": "error",
                     "traceback": traceback.format_exc()}
            r["mesh"] = mesh_name
            _dump(args.out, tag, r)
            results.append(r)

    ok = sum(1 for r in results if r["status"] == "ok")
    skip = sum(1 for r in results if r["status"] == "skipped")
    err = sum(1 for r in results if r["status"] == "error")
    print(f"[dryrun] done: {ok} ok, {skip} skipped, {err} errors "
          f"({time.time() - t0:.1f}s)")
    if err:
        for r in results:
            if r["status"] == "error":
                print(f"  ERROR {r['cell']['arch']} {r['cell'].get('shape')}")
        raise SystemExit(1)
    return results


def _dump(out_dir, tag, result):
    path = os.path.join(out_dir, tag + ".json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1, default=str)
    st = result["status"]
    extra = ""
    if st == "ok":
        ro = result["roofline"]
        extra = (f" count={result['compile_s']}s flops={ro['flops']:.2e} "
                 f"coll={ro['coll_bytes']:.2e} bott={ro['bottleneck']} "
                 f"useful={ro['useful_ratio']:.2f} "
                 f"replicated_ops={sum(result['fallbacks'].values())}")
    print(f"[dryrun] {tag}: {st}{extra}", flush=True)


if __name__ == "__main__":
    main()
