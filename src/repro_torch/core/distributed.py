"""Distributed partitioned-MVM GP engine over a `torch.distributed` mesh.

The counterpart of `repro.core.distributed`: the paper's Section 3
("Distributed MVMs in Parallel"), one process per card (or per CPU worker
on gloo), every rank running the same program on its own shard. Two modes:

  * ``mode="1d"`` — the paper's scheme. Kernel-matrix ROWS are partitioned
    over every mesh axis; each rank holds a row shard of every CG vector.
    One iteration: all-gather the search direction over the row axes (O(n)
    bytes per rank — the paper's communication claim), compute the local
    `K(B_i, X) @ p_full` slab-blockwise, add the local noise diagonal,
    all-reduce the CG dot products.

  * ``mode="2d"`` — beyond the paper. Rows are sharded over the row axes
    (pod, data) AND columns over the col axis (model). CG vectors are
    sharded over ALL axes (chunk c = B_i[sub_j], the j-th sub-slice of row
    block i). One iteration:
        v[C_j]  = all_gather(v_local over row axes)          (n/tp bytes)
        partial = K(B_i, C_j) @ v[C_j]                        (local tile)
        o_local = reduce_scatter(partial over col axes)       (n/dp bytes)
    The column blocks C_j = U_i B_i[sub_j] are strided, so the scatter
    output lands exactly in the vector's storage layout.

Where the reference runs inside `shard_map` with collectives named by mesh
axis, the port runs in every rank's process, and a `DistGeometry` carries
the `repro_torch.launch.mesh.Mesh` whose subgroups those collectives use:
`all_gather` -> `all_gather_into_tensor`, `psum_scatter` ->
`reduce_scatter_tensor`, `psum`/`pmax`/`pmin` -> `all_reduce`, and the
ring's `ppermute` -> `batch_isend_irecv` to the +1 neighbour. NCCL serves
CUDA tensors and gloo CPU tensors; an operator whose tensors lie elsewhere
than its group serves raises. X (n, d) is replicated on every rank (the
paper's own assumption); the pivoted-Cholesky factor and all CG state are
sharded.

On the fused (`"pallas"`) inner backend every chunk step of the 2-D / ring
contraction is ONE launch of the chunk-accumulate kernel (`kmvm_fused_chunk`,
which replaces the reference's `kmvm_pallas_chunk`), carrying the (rows,
t) fp32 partial in place from step to step; the 1-D serial path runs the
fused kernel per slab through `kmvm_rect`, as the reference does.

The engine plugs into the stack as `ShardedOperator`, the "sharded" entry
of the operator registry, so the MLL forward is `mll.operator_mll_forward`
itself, run on every rank; the Eq. 2 backward is a `torch.autograd.Function`
whose gradients are per-rank partials all-reduced in the backward — the
collectives are never differentiated through.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .kernels_math import (
    constant_mean,
    kernel_diag,
    kernel_matrix,
    noise_variance,
    params_leaves,
    params_map,
    params_unflatten,
)
from .mll import operator_mll_forward, operator_mll_quad_grads
from .operators import (
    KernelOperator,
    OperatorConfig,
    _compute_dtype_of,
    register_operator,
    slab_acc_fn_for,
    slab_block_fn_for,
)
from .partitioned import kmvm_rect, quad_form_partials
from .pcg import pcg

# the non-deprecated names where the installed torch has them
_all_gather_tensor = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_tensor = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)


class DistGeometry(NamedTuple):
    """Static layout of the distributed engine on a mesh (the reference's
    fields, plus the `mesh` whose process groups the collectives use).

    When n does not divide the shard grid the layout is PADDED: arrays carry
    `n_padded` rows (pad rows zero in X/y), every collective and tile runs on
    the padded shapes, and a per-chunk mask confines the solver to the true
    rows — K_hat_pad = M K M + s2 I is block-diagonal (K_hat_true, s2 I_pad),
    so masked CG vectors never mix with the pad block and the MLL/gradients
    cover exactly the n true rows. With `n_pad is None` (n divides) no mask
    is applied at all.
    """

    n: int                      # global TRUE training-set size
    d: int                      # input dimension
    row_axes: tuple             # mesh axes sharding kernel ROWS
    col_axes: tuple             # mesh axes sharding kernel COLUMNS (() = 1-D)
    d_row: int                  # prod of row-axis sizes
    d_col: int                  # prod of col-axis sizes (1 in 1-D mode)
    row_block: int = 1024       # inner slab blocking of the local tile
    n_pad: int | None = None    # padded global size (None = n divides)
    overlap: bool = False       # ring-pipeline the gather with tile compute
    row_sizes: tuple = ()       # per-axis sizes of row_axes (ring bounds)
    col_sizes: tuple = ()       # per-axis sizes of col_axes
    mesh: object | None = None  # repro_torch.launch.mesh.Mesh

    @property
    def all_axes(self) -> tuple:
        return (*self.row_axes, *self.col_axes)

    def vector_pspec(self) -> tuple:
        """The spec of a CG vector (n_padded, ...) in `models.sharding`'s
        form: dim 0 sharded over every mesh axis, row axes major. The
        engine cuts its vector chunks by it (`_chunk_index`)."""
        return (self.all_axes,)

    @property
    def n_padded(self) -> int:
        return self.n if self.n_pad is None else self.n_pad

    @property
    def has_pad(self) -> bool:
        return self.n_padded != self.n

    @property
    def pad_rows(self) -> int:
        return self.n_padded - self.n

    @property
    def n_local(self) -> int:   # CG-vector chunk per rank
        return self.n_padded // (self.d_row * self.d_col)

    @property
    def rows_local(self) -> int:  # kernel rows per row group
        return self.n_padded // self.d_row

    @property
    def cols_local(self) -> int:  # kernel cols per col group
        return self.n_padded // self.d_col


def make_geometry(mesh, n: int, d: int, *, mode: str = "2d",
                  row_block: int = 1024, overlap: bool = False,
                  tile_multiple: int = 1) -> DistGeometry:
    """1d (paper-faithful): rows partitioned over EVERY mesh axis. 2d
    (beyond-paper): rows over (pod, data), columns over model.

    Any n runs on any mesh: when n does not divide the shard grid the
    geometry pads to the next multiple (masked rows — see DistGeometry).
    `tile_multiple` additionally forces every per-rank chunk to hold whole
    sparsity tiles (blocksparse: pass the plan's tile size). `overlap=True`
    pipelines the per-iteration gather against the local tile compute.
    """
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    if mode == "1d":
        row_axes = tuple(a for a in ("pod", "data", "model") if a in sizes)
        col_axes = ()
    elif mode == "2d":
        row_axes = tuple(a for a in ("pod", "data") if a in sizes)
        col_axes = ("model",) if "model" in sizes else ()
    else:
        raise ValueError(f"unknown mode {mode!r} (1d | 2d)")
    d_row = int(np.prod([sizes[a] for a in row_axes]))
    d_col = int(np.prod([sizes[a] for a in col_axes])) if col_axes else 1
    m = d_row * d_col * max(int(tile_multiple), 1)
    n_padded = -(-n // m) * m
    n_pad = None if n_padded == n else n_padded
    return DistGeometry(n=n, d=d, row_axes=row_axes, col_axes=col_axes,
                        d_row=d_row, d_col=d_col, row_block=row_block,
                        n_pad=n_pad, overlap=overlap,
                        row_sizes=tuple(sizes[a] for a in row_axes),
                        col_sizes=tuple(sizes[a] for a in col_axes),
                        mesh=mesh)


def pad_to_geometry(geom: DistGeometry, arr):
    """Zero-pad axis 0 from geom.n to geom.n_padded (no-op when n divides).

    Apply to X / y / any full-length vector BEFORE replicate/shard_vector;
    the pad rows are masked out of every solve, so zeros are just layout.
    Takes a tensor or a numpy array and returns the same kind."""
    extra = geom.n_padded - arr.shape[0]
    if extra <= 0:
        return arr
    if isinstance(arr, torch.Tensor):
        pad = arr.new_zeros((extra,) + tuple(arr.shape[1:]))
        return torch.cat([arr, pad], dim=0)
    return np.pad(np.asarray(arr), [(0, extra)] + [(0, 0)] * (np.ndim(arr) - 1))


# ---------------------------------------------------------------------------
# local-shard helpers and collectives (every rank calls them in step)
# ---------------------------------------------------------------------------


def _mesh(geom: DistGeometry):
    if geom.mesh is None:
        raise ValueError("DistGeometry has no mesh: build it with "
                         "make_geometry(mesh, ...)")
    return geom.mesh


def _linear_index(mesh, axes: tuple) -> int:
    idx = 0
    for a in axes:
        idx = idx * mesh.axis_size(a) + mesh.axis_index(a)
    return idx


def _all_reduce(mesh, axes: tuple, x: torch.Tensor, op=dist.ReduceOp.SUM):
    """all_reduce over `axes` into a new tensor (x is left as it is)."""
    y = x.clone(memory_format=torch.contiguous_format)
    if axes:
        dist.all_reduce(y, op=op, group=mesh.group(axes))
    return y


def _all_gather(mesh, axes: tuple, x: torch.Tensor) -> torch.Tensor:
    """Tiled all-gather along axis 0 over `axes` (row-major rank order)."""
    if not axes:
        return x
    k = len(mesh.group_ranks(axes))
    x = x.contiguous()
    out = x.new_empty((k * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather_tensor(out, x, group=mesh.group(axes))
    return out


def _reduce_scatter(mesh, axes: tuple, x: torch.Tensor) -> torch.Tensor:
    """Tiled sum-reduce-scatter along axis 0 over `axes`."""
    if not axes:
        return x
    k = len(mesh.group_ranks(axes))
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // k,) + tuple(x.shape[1:]))
    _reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=mesh.group(axes))
    return out


def _x_rows(geom: DistGeometry, X: torch.Tensor) -> torch.Tensor:
    """X[B_i] for this rank's row group (rows_local, d)."""
    if not geom.row_axes:
        return X
    i = _linear_index(_mesh(geom), geom.row_axes)
    return X[i * geom.rows_local:(i + 1) * geom.rows_local]


def _x_cols(geom: DistGeometry, X: torch.Tensor) -> torch.Tensor:
    """X[C_j] for this rank's column group (cols_local, d); C_j is strided:
    the j-th n_local sub-slice of every row block B_i."""
    if not geom.col_axes:
        return X
    j = _linear_index(_mesh(geom), geom.col_axes)
    Xr = X.reshape(geom.d_row, geom.d_col * geom.n_local, geom.d)
    sl = Xr[:, j * geom.n_local:(j + 1) * geom.n_local]
    return sl.reshape(geom.d_row * geom.n_local, geom.d)


def _chunk_index(geom: DistGeometry) -> int:
    """This rank's CG-vector chunk: its linear index over the axes that
    shard a vector's dim 0 (`vector_pspec`)."""
    return _linear_index(_mesh(geom), geom.vector_pspec()[0])


def _x_chunk(geom: DistGeometry, X: torch.Tensor) -> torch.Tensor:
    """X rows for this rank's CG-vector chunk (n_local, d)."""
    c = _chunk_index(geom)
    return X[c * geom.n_local:(c + 1) * geom.n_local]


def _chunk_offset(geom: DistGeometry) -> int:
    return _chunk_index(geom) * geom.n_local


def _psum_all(geom: DistGeometry, x: torch.Tensor) -> torch.Tensor:
    return _all_reduce(_mesh(geom), geom.all_axes, x)


def _chunk_mask(geom: DistGeometry, dtype) -> torch.Tensor | None:
    """(n_local,) 1/0 mask of TRUE rows in this rank's vector chunk, or None
    when the geometry has no padding. Pad rows are the global tail, so only
    trailing chunks carry zeros."""
    if not geom.has_pad:
        return None
    gidx = _chunk_offset(geom) + torch.arange(geom.n_local,
                                              device=_mesh(geom).device)
    return (gidx < geom.n).to(dtype)


# ---------------------------------------------------------------------------
# distributed K_hat MVM (the paper's partitioned MVM on the mesh)
# ---------------------------------------------------------------------------
#
# The 2-D tile contraction K(B_i, :) @ V is decomposed over SOURCE chunks:
# each rank accumulates sum_s K(B_i, chunk_s) @ V[chunk_s] over the d_row
# chunks its column group holds. Two executions of the SAME accumulation
# order:
#
#   serial  — one all-gather over the row axes up front, then slice chunk s
#             out of the gathered buffer per step;
#   overlap — collective matmul: the chunks ring-rotate by point-to-point
#             sends to the +1 neighbour, and the transfer for step s+1 is
#             posted BEFORE the tile compute of step s (NCCL runs it on its
#             own stream; the receive lands in a second buffer that step
#             s's kernel does not read, and `wait()` orders the compute
#             stream after it before step s+1 reads it).
#
# Both walk source chunks in the same per-rank ring order and call the same
# chunk step on the same operands, so overlap on/off is bitwise-identical.


def _ring_schedule(sizes: tuple) -> list[tuple[int | None, tuple]]:
    """Static per-step plan for a multi-axis ring over `sizes`.

    Returns prod(sizes) entries (shift_axis, offsets): `shift_axis` is the
    row-axis position to shift by +1 to ARRIVE at this step (None for step
    0), `offsets[j]` the accumulated shift count of axis j — a rank at
    coords (i_j) then holds the chunk of row group prod-index over
    ((i_j - offsets[j]) mod sizes[j]). Nested-odometer order: one
    single-hop shift per step visits all d_row sources."""
    m = len(sizes)
    total = int(np.prod(sizes)) if sizes else 1
    inner = [int(np.prod(sizes[j + 1:])) for j in range(m)]  # cycle lengths
    counts = [0] * m
    sched: list[tuple[int | None, tuple]] = []
    for k in range(total):
        if k == 0:
            ax = None
        else:
            ax = m - 1
            for j in range(m):
                if k % inner[j] == 0:
                    ax = j
                    break
            counts[ax] += 1
        sched.append((ax, tuple(counts)))
    return sched


def _ring_src_index(geom: DistGeometry, offsets: tuple) -> int:
    """Linear row-group index of the chunk this rank holds at the ring step
    with the given per-axis shift counts."""
    mesh = _mesh(geom)
    idx = 0
    for a, s, off in zip(geom.row_axes, geom.row_sizes, offsets):
        idx = idx * s + (mesh.axis_index(a) - off) % s
    return idx


def _chunked_contraction(geom: DistGeometry, chunk_fn: Callable,
                         V_local: torch.Tensor, *, overlap: bool):
    """Fold chunk_fn(c_s, V[chunk c_s], partial) -> partial over the d_row
    source chunks (partial is None at the first step).

    c is the GLOBAL vector-chunk index (chunk c covers rows [c*n_local,
    (c+1)*n_local)). The sources are walked in ring order from this rank's
    own chunk; serial (overlap=False) slices an up-front all-gather in that
    same order.
    """
    if not geom.row_sizes:
        raise ValueError(
            "chunked contraction needs DistGeometry.row_sizes (build the "
            "geometry with make_geometry, not the raw constructor)")
    mesh = _mesh(geom)
    sched = _ring_schedule(geom.row_sizes)
    j_col = _linear_index(mesh, geom.col_axes) if geom.col_axes else 0

    partial = None
    if overlap:
        v = V_local.contiguous()
        for k, (_, offsets) in enumerate(sched):
            works, v_next = None, None
            if k + 1 < len(sched):
                name = geom.row_axes[sched[k + 1][0]]
                v_next = torch.empty_like(v)
                # post the transfer for step k+1 BEFORE step k's compute
                works = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, v, mesh.shifted_rank(name, 1)),
                    dist.P2POp(dist.irecv, v_next, mesh.shifted_rank(name, -1)),
                ])
            src = _ring_src_index(geom, offsets)
            partial = chunk_fn(src * geom.d_col + j_col, v, partial)
            if works is not None:
                for w in works:
                    w.wait()
                v = v_next
    else:
        v_all = _all_gather(mesh, geom.row_axes, V_local)
        for _, offsets in sched:
            src = _ring_src_index(geom, offsets)
            v = v_all[src * geom.n_local:(src + 1) * geom.n_local]
            partial = chunk_fn(src * geom.d_col + j_col, v, partial)
    return partial


def dist_kmvm(geom: DistGeometry, kernel, X: torch.Tensor,
              V_local: torch.Tensor, params, *, add_noise: bool = True,
              noise_floor: float = 1e-4,
              block_fn: Callable | None = None,
              acc_fn: Callable | None = None,
              overlap: bool | None = None) -> torch.Tensor:
    """K_hat @ V with V sharded per geom. Local in, local out.

    1-D serial: all-gather(V) -> (n, t); rows B_i x full columns (the
        paper's scheme) through `kmvm_rect` with `block_fn`.
    2-D / overlap: chunked contraction over source chunks (see
        `_chunked_contraction`); each step is `acc_fn(x_rows, x_chunk, v,
        params, acc)` (the fused backend's chunk-accumulate kernel, acc an
        fp32 (rows_local, t) partial carried in place) when given, else
        `kmvm_rect` added to the partial. 2-D closes with a reduce-scatter
        of the row partials over the col axes.
    Padded geometries mask V in and the kernel part out, then add the noise
    diagonal unmasked — K_hat_pad stays SPD and block-diagonal.
    """
    squeeze = V_local.ndim == 1
    if squeeze:
        V_local = V_local[:, None]
    overlap = geom.overlap if overlap is None else overlap
    mesh = _mesh(geom)

    mask = _chunk_mask(geom, V_local.dtype)
    Vk = V_local if mask is None else V_local * mask[:, None]
    x_rows = _x_rows(geom, X)
    if geom.col_axes or overlap:
        def chunk_fn(c, v, partial):
            x_c = X[c * geom.n_local:(c + 1) * geom.n_local]
            if acc_fn is not None:
                if partial is None:
                    partial = torch.zeros((geom.rows_local, v.shape[1]),
                                          dtype=torch.float32, device=v.device)
                return acc_fn(x_rows, x_c, v, params, partial)
            out = kmvm_rect(kernel, x_rows, x_c, v, params,
                            row_block=geom.row_block, block_fn=block_fn)
            return out if partial is None else partial + out

        partial_rows = _chunked_contraction(geom, chunk_fn, Vk,
                                            overlap=overlap)
        partial_rows = partial_rows.to(V_local.dtype)
    else:
        v_cols = _all_gather(mesh, geom.row_axes, Vk)
        partial_rows = kmvm_rect(kernel, x_rows, _x_cols(geom, X), v_cols,
                                 params, row_block=geom.row_block,
                                 block_fn=block_fn)
    out = _reduce_scatter(mesh, geom.col_axes, partial_rows)
    if mask is not None:
        out = out * mask[:, None]
    if add_noise:
        out = out + noise_variance(params, noise_floor) * V_local
    return out[:, 0] if squeeze else out


# ---------------------------------------------------------------------------
# distributed rank-k pivoted Cholesky (L sharded congruent with CG vectors)
# ---------------------------------------------------------------------------


class DistPreconditioner(NamedTuple):
    L_local: torch.Tensor     # (n_local, k) rows of L for this rank's chunk
    sigma2: torch.Tensor      # () replicated
    chol_inner: torch.Tensor  # (k, k) replicated Cholesky of s2 I + L^T L
    n: int

    def solve(self, geom: DistGeometry, V_local: torch.Tensor) -> torch.Tensor:
        LtV = _psum_all(geom, self.L_local.T @ V_local)   # (k, t) replicated
        inner = torch.cholesky_solve(LtV, self.chol_inner, upper=False)
        return (V_local - self.L_local @ inner) / self.sigma2

    def logdet(self) -> torch.Tensor:
        k = self.L_local.shape[1]
        ld_inner = 2.0 * torch.sum(torch.log(torch.diagonal(self.chol_inner)))
        return (self.n - k) * torch.log(self.sigma2) + ld_inner

    def sample(self, geom: DistGeometry, generator: torch.Generator, num: int,
               dtype=None) -> torch.Tensor:
        """(n_local, num) probe chunk of z ~ N(0, P), masked to the true rows
        on padded geometries. `generator` must be seeded alike on every rank:
        the shared draw e1 (k, num) comes from it, and this rank's e2 chunk
        from a generator seeded with a draw of it and the rank's linear chunk
        index (the reference folds the index into its key)."""
        if generator is None:
            raise ValueError("distributed probes need a torch.Generator "
                             "seeded alike on every rank")
        dtype = dtype or self.L_local.dtype
        dev = self.L_local.device
        k = self.L_local.shape[1]
        e1 = torch.randn((k, num), generator=generator, dtype=dtype, device=dev)
        base = int(torch.randint(0, 2**62, (1,), generator=generator, device=dev))
        c = _chunk_index(geom)
        g2 = torch.Generator(device=dev).manual_seed(
            (base + (c + 1) * 0x9E3779B97F4A7C15) % 2**63)
        e2 = torch.randn((geom.n_local, num), generator=g2, dtype=dtype, device=dev)
        out = self.L_local.to(dtype) @ e1 + torch.sqrt(self.sigma2).to(dtype) * e2
        mask = _chunk_mask(geom, out.dtype)
        return out if mask is None else out * mask[:, None]


def dist_pivoted_cholesky(geom: DistGeometry, kernel, X: torch.Tensor,
                          params, rank: int) -> torch.Tensor:
    """Rank-k pivoted Cholesky with rows sharded over the mesh.

    The greedy pivot search needs three tiny collectives per step: a MAX of
    the residual diagonal, a MIN of the candidates' global indices (the
    tie-break: the lowest global index among the maxima, as on one device),
    and one SUM broadcasting the pivot point x_p (d,) with the pivot's L row
    (k,) from its owner. Communication O(rank * (d + rank)).
    """
    mesh = _mesh(geom)
    axes = geom.all_axes
    x_chunk = _x_chunk(geom, X)             # (n_local, d)
    gidx = _chunk_offset(geom) + torch.arange(geom.n_local, device=X.device)
    diag = kernel_diag(kernel, x_chunk, params).clone()
    mask = _chunk_mask(geom, X.dtype)
    if mask is not None:
        # pad rows: zero residual diagonal (never chosen as pivot while a
        # true row remains) and zero L rows (P stays block-diagonal)
        diag = diag * mask
    L = torch.zeros((geom.n_local, rank), dtype=X.dtype, device=X.device)
    d = X.shape[1]
    for i in range(rank):
        # a (1,) index tensor, not a 0-d one: indexing by a 0-d tensor reads
        # it on the host (a sync per pivot on the card)
        local_arg = torch.argmax(diag).reshape(1)
        local_max = diag[local_arg][0]
        arg_gidx = gidx[local_arg][0]
        global_max = _all_reduce(mesh, axes, local_max, dist.ReduceOp.MAX)
        cand = torch.where(local_max >= global_max, arg_gidx,
                           torch.full_like(arg_gidx, geom.n_padded))
        pivot_gidx = _all_reduce(mesh, axes, cand, dist.ReduceOp.MIN)
        ownf = (arg_gidx == pivot_gidx).to(X.dtype)
        both = _all_reduce(mesh, axes, ownf * torch.cat([x_chunk[local_arg][0],
                                                         L[local_arg][0]]))
        xp, lp = both[:d], both[d:]
        pivot_val = torch.clamp(global_max, min=1e-12)

        row = kernel_matrix(kernel, xp[None], x_chunk, params)[0]  # (n_local,)
        if mask is not None:
            row = row * mask
        row = row - L @ lp
        li = row / torch.sqrt(pivot_val)
        here = gidx == pivot_gidx
        li = torch.where(here, torch.sqrt(pivot_val), li)
        if mask is not None:
            li = li * mask  # rank > true rows: a pad pivot still stays zero
        L[:, i] = li
        diag = torch.clamp(diag - li * li, min=0.0)
        diag = torch.where(here, torch.full_like(diag, -float("inf")), diag)
    return L


def make_dist_preconditioner(geom: DistGeometry, kernel, X: torch.Tensor,
                             params, rank: int,
                             noise_floor: float = 1e-4,
                             jitter: float = 1e-6) -> DistPreconditioner:
    s2 = noise_variance(params, noise_floor)
    if rank <= 0:
        L = torch.zeros((geom.n_local, 0), dtype=X.dtype, device=X.device)
        return DistPreconditioner(L, s2, torch.zeros((0, 0), dtype=X.dtype,
                                                     device=X.device), geom.n)
    L = dist_pivoted_cholesky(geom, kernel, X, params, rank)
    eye = torch.eye(rank, dtype=L.dtype, device=L.device)
    inner = s2 * eye + _psum_all(geom, L.T @ L) + jitter * eye
    return DistPreconditioner(L, s2, torch.linalg.cholesky(inner), geom.n)


# ---------------------------------------------------------------------------
# ShardedOperator — the "sharded" registry backend
# ---------------------------------------------------------------------------


class _BoundDistPreconditioner(NamedTuple):
    """DistPreconditioner with geom bound in, matching the single-device
    `Preconditioner.solve/logdet/sample` surface the solvers expect."""

    geom: DistGeometry
    pre: DistPreconditioner

    @property
    def rank(self) -> int:
        return self.pre.L_local.shape[1]

    def solve(self, V_local: torch.Tensor) -> torch.Tensor:
        return self.pre.solve(self.geom, V_local)

    def logdet(self) -> torch.Tensor:
        return self.pre.logdet()

    def sample(self, generator, num: int, dtype=None) -> torch.Tensor:
        return self.pre.sample(self.geom, generator, num, dtype)


@register_operator("sharded")
class ShardedOperator(KernelOperator):
    """K_hat over a mesh: rows (and optionally columns) sharded per
    `config.geom` (a DistGeometry), composing an inner backend for the local
    tiles (`config.inner_backend`: "partitioned" = dense slabs, "pallas" =
    the fused kernels, one chunk-accumulate launch per ring step,
    "blocksparse" = the block-sparse kernel over a pre-sorted plan).

    Run on every rank in step: matvec takes and returns this rank's
    (n_local, t) chunk, scalar reductions go through `allreduce`, and
    `quad_form_grads` returns this rank's PARTIAL gradients (the MLL
    backward all-reduces them — see `make_dist_mll`). `shape` reports the
    GLOBAL true n. X is the full padded (n_padded, d) array, on the device
    the mesh's group serves.

    Prediction surfaces (cross_matvec / kernel_rows) are single-device by
    design — predictions run on one device from the gathered mean cache
    (`make_mean_cache_solve`). The fused-CG step is not claimed (the
    cross-rank launch cannot fuse); PCG uses the plain matvec and
    allreduces its dots.
    """

    def __init__(self, config: OperatorConfig, X: torch.Tensor, params):
        super().__init__(config, X, params)
        if config.geom is None:
            raise ValueError("backend='sharded' requires OperatorConfig.geom")
        self.geom: DistGeometry = config.geom
        mesh = _mesh(self.geom)
        if X.device.type != mesh.device.type:
            raise ValueError(
                f"a {X.device.type} operator cannot run on the mesh's "
                f"{mesh.backend!r} group, which serves {mesh.device.type} "
                f"tensors")
        if X.shape[0] != self.geom.n_padded:
            raise ValueError(f"X has {X.shape[0]} rows; the geometry lays out "
                             f"{self.geom.n_padded} (pad_to_geometry)")
        if config.inner_backend == "blocksparse":
            from repro_torch.sparse.blocksparse import validate_dist_plan

            if config.plan is None:
                raise ValueError(
                    "inner_backend='blocksparse' requires a pre-built "
                    "OperatorConfig.plan (assume_sorted=True)")
            validate_dist_plan(self.geom, config.plan)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.geom.n, self.geom.n)

    @property
    def local_mask(self) -> torch.Tensor | None:
        """(n_local,) true-row mask of this rank's vector chunk (None when
        the geometry is unpadded)."""
        return _chunk_mask(self.geom, self.dtype)

    @classmethod
    def slab_block_fn(cls, config: OperatorConfig, operand_dtype):
        raise ValueError("'sharded' cannot be an inner slab backend")

    def matvec(self, V_local: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        if cfg.inner_backend == "blocksparse":
            from repro_torch.sparse.blocksparse import dist_blocksparse_kmvm

            return dist_blocksparse_kmvm(
                self.geom, cfg.kernel, self.X, V_local, self.params, cfg.plan,
                add_noise=cfg.add_noise, noise_floor=cfg.noise_floor,
                compute_dtype=_compute_dtype_of(cfg, self.dtype))
        return dist_kmvm(
            self.geom, cfg.kernel, self.X, V_local, self.params,
            add_noise=cfg.add_noise, noise_floor=cfg.noise_floor,
            block_fn=slab_block_fn_for(cfg.inner_backend, cfg, self.dtype),
            acc_fn=slab_acc_fn_for(cfg.inner_backend, cfg, self.dtype))

    def allreduce(self, x: torch.Tensor) -> torch.Tensor:
        return _psum_all(self.geom, x)

    def preconditioner(self, rank: int, reuse=None) -> _BoundDistPreconditioner:
        """`reuse` accepts the bound preconditioner a previous call returned
        or the raw DistPreconditioner a DistSolveState carries."""
        if reuse is not None:
            pre = reuse.pre if isinstance(reuse, _BoundDistPreconditioner) \
                else reuse
            if pre.L_local.shape[1] != max(rank, 0):
                raise ValueError(
                    f"cannot reuse a rank-{pre.L_local.shape[1]} "
                    f"preconditioner for rank={rank}")
            return _BoundDistPreconditioner(self.geom, pre)
        return _BoundDistPreconditioner(
            self.geom,
            make_dist_preconditioner(self.geom, self.config.kernel, self.X,
                                     self.params, rank,
                                     self.config.noise_floor))

    def cross_matvec(self, Z, V):
        raise NotImplementedError(
            "ShardedOperator is solve-only; gather the mean cache "
            "(make_mean_cache_solve) and predict with a single-device "
            "operator")

    def kernel_rows(self, Z):
        raise NotImplementedError(
            "ShardedOperator is solve-only; see cross_matvec")

    def quad_form_grads(self, A_loc: torch.Tensor, V_loc: torch.Tensor,
                        need_x: bool = True):
        """This rank's PARTIAL (g_params, g_X) of sum_j a_j^T K_hat v_j
        (g_X whatever `need_x` says; `dist_mll_backward` drops it).

        With o = reduce_scatter(partial_rows), sum_rank <A_loc, o_loc> =
        sum_rank <A_rows, partial_rows> where A_rows = all_gather(A_loc) over
        the COLUMN axes — so each rank owns the disjoint tile term
        <A[B_i], K(B_i, C_j) V[C_j]> and its gradient, evaluated blockwise
        with bounded memory by `quad_form_partials`. The caller all-reduces
        the results.
        """
        geom = self.geom
        mesh = _mesh(geom)
        X = self.X
        if A_loc.ndim == 1:
            A_loc = A_loc[:, None]
        if V_loc.ndim == 1:
            V_loc = V_loc[:, None]
        v_cols = _all_gather(mesh, geom.row_axes, V_loc)
        a_rows = _all_gather(mesh, geom.col_axes, A_loc)
        gp, g_rows, g_cols = quad_form_partials(
            self.config.kernel, _x_rows(geom, X), _x_cols(geom, X), a_rows,
            v_cols, self.params, row_block=max(geom.row_block // 2, 64))
        gp = self._add_noise_grad(gp, A_loc, V_loc)

        # scatter row/col gradients back into the replicated-X layout
        g_X = torch.zeros_like(X)
        if geom.row_axes:
            i = _linear_index(mesh, geom.row_axes)
            g_X[i * geom.rows_local:(i + 1) * geom.rows_local] = g_rows
        else:
            g_X += g_rows
        if geom.col_axes:
            j = _linear_index(mesh, geom.col_axes)
            gc = g_X.view(geom.d_row, geom.d_col * geom.n_local, geom.d)
            gc[:, j * geom.n_local:(j + 1) * geom.n_local] += g_cols.reshape(
                geom.d_row, geom.n_local, geom.d)
        else:
            g_X += g_cols
        return gp, g_X


# ---------------------------------------------------------------------------
# distributed MLL with the Eq. 2 backward (paper Eq. 1 & 2, sharded)
# ---------------------------------------------------------------------------


class DistMLLConfig(NamedTuple):
    kernel: str = "matern32"
    precond_rank: int = 100
    num_probes: int = 8
    max_cg_iters: int = 20
    min_cg_iters: int = 3
    cg_tol: float = 1.0
    noise_floor: float = 1e-4
    pcg_method: str = "standard"
    backend: str = "partitioned"          # inner backend per tile
    compute_dtype: str | None = None      # "bfloat16" = bf16 operands
    plan: object | None = None            # SparsePlan (backend="blocksparse":
                                          # pre-sorted data)

    def operator_config(self, geom: DistGeometry) -> OperatorConfig:
        return OperatorConfig(
            kernel=self.kernel, backend="sharded", row_block=geom.row_block,
            add_noise=True, noise_floor=self.noise_floor,
            compute_dtype=self.compute_dtype, geom=geom,
            inner_backend=self.backend, plan=self.plan)


def _dist_mll_forward(geom, cfg, X, y_loc, params, generator, *,
                      precond=None, probes=None):
    op = ShardedOperator(cfg.operator_config(geom), X, params)
    if precond is not None:
        precond = op.preconditioner(cfg.precond_rank, reuse=precond)
    (value, aux), (_, u_y, U, pinv_z), _ = operator_mll_forward(
        op, y_loc, generator,
        precond_rank=cfg.precond_rank, num_probes=cfg.num_probes,
        max_cg_iters=cfg.max_cg_iters, min_cg_iters=cfg.min_cg_iters,
        cg_tol=cfg.cg_tol, pcg_method=cfg.pcg_method, precond=precond,
        probes=probes)
    aux = (aux.logdet, aux.quad, aux.cg_iterations, aux.rel_residual)
    return (value, aux), (u_y, U, pinv_z)


def dist_mll_backward(geom, cfg, X, params, u_y, U, pinv_z, g_value, *,
                      need_x: bool = True):
    """This rank's (g_X, g_y, g_params) of g_value * mll: g_params and g_X
    all-reduced (replicated), g_y this rank's chunk.

    `ShardedOperator.quad_form_grads` returns per-rank partials (explicit
    blockwise tiles, not autograd through the distributed forward), so the
    shared Eq. 2 assembly yields partials too, summed here in ONE
    all-reduce. The backward contracts in full precision. With `need_x`
    False, g_X (n x d, the all-reduce's bulk) is left out of it and comes
    back None, as XLA drops the reference's unused g_X psum."""
    bwd_cfg = cfg.operator_config(geom)._replace(compute_dtype=None)
    g_params, g_X = operator_mll_quad_grads(
        lambda x: ShardedOperator(bwd_cfg, x, params), X, u_y, U, pinv_z)
    leaves = params_leaves(g_params)
    parts = [a.reshape(-1) for a in leaves]
    if need_x:
        parts.append(g_X.reshape(-1))
    parts.append(torch.sum(u_y).reshape(1))
    total = _psum_all(geom, torch.cat([p.to(g_X.dtype) for p in parts]))
    out, off = [], 0
    for a in leaves:
        out.append(total[off:off + a.numel()].reshape(a.shape).to(a.dtype))
        off += a.numel()
    g_X = g_value * total[off:off + g_X.numel()].reshape(g_X.shape) \
        if need_x else None
    sum_uy = total[-1]
    g_params = params_unflatten(g_params, out)
    g_params = g_params._replace(raw_mean=g_params.raw_mean + sum_uy)
    g_params = params_map(lambda a: g_value * a, g_params)
    return g_X, g_value * (-u_y), g_params


class _DistMLL(torch.autograd.Function):
    """value = mll(X, y_loc, params) on every rank, with the Eq. 2 backward;
    the params tree travels as its leaves."""

    @staticmethod
    def forward(ctx, geom, cfg, generator, inject, template, X, y_loc, *leaves):
        params = params_unflatten(template, [a.detach() for a in leaves])
        X, y_loc = X.detach(), y_loc.detach()
        (value, aux), (u_y, U, pinv_z) = _dist_mll_forward(
            geom, cfg, X, y_loc, params, generator, **inject)
        ctx.geom, ctx.cfg, ctx.params = geom, cfg, params
        ctx.save_for_backward(X, u_y, U, pinv_z)
        ctx.mark_non_differentiable(*aux)
        return (value,) + aux

    @staticmethod
    def backward(ctx, g_value, *_):
        X, u_y, U, pinv_z = ctx.saved_tensors
        g_X, g_y, g_params = dist_mll_backward(
            ctx.geom, ctx.cfg, X, ctx.params, u_y, U, pinv_z, g_value,
            need_x=ctx.needs_input_grad[5])
        return (None,) * 5 + (g_X, g_y, *params_leaves(g_params))


def make_dist_mll(geom: DistGeometry, cfg: DistMLLConfig):
    """Returns mll(X, y_loc, params, generator, *, precond=None,
    probes=None) -> (value, (logdet, quad, cg_iterations, rel_residual)),
    run on every rank; value is differentiable w.r.t. X, y_loc and every
    params leaf (gradients all-reduced in the backward). `precond` (a
    DistPreconditioner) and `probes` (this rank's chunk) inject the
    randomness instead of drawing it."""

    def mll(X, y_loc, params, generator=None, *, precond=None, probes=None):
        out = _DistMLL.apply(geom, cfg, generator,
                             {"precond": precond, "probes": probes}, params,
                             X, y_loc, *params_leaves(params))
        return out[0], tuple(out[1:])

    return mll


def _check_mesh(mesh, geom: DistGeometry) -> None:
    if mesh is not _mesh(geom):
        raise ValueError("the geometry was built on another mesh")


def make_mll_value_and_grad(mesh, geom: DistGeometry, cfg: DistMLLConfig):
    """(X, y_loc, params, generator) -> (loss, aux, grads) on every rank:
    loss = -mll / n, aux = (logdet, quad, cg_iterations, rel_residual),
    grads replicated. X full (padded) on the mesh's device, y_loc this
    rank's chunk (`shard_vector`). `precond=` / `probes=` inject."""
    _check_mesh(mesh, geom)
    mll = make_dist_mll(geom, cfg)

    def fn(X, y_loc, params, generator=None, *, precond=None, probes=None):
        leaves = [a.detach().requires_grad_(True) for a in params_leaves(params)]
        with torch.enable_grad():
            value, aux = mll(X, y_loc, params_unflatten(params, leaves),
                             generator, precond=precond, probes=probes)
            loss = -value / geom.n
            g = torch.autograd.grad(loss, leaves)
        return loss.detach(), aux, params_unflatten(params, list(g))

    return fn


class DistSolveState(NamedTuple):
    """Sharded warm-start state threaded across optimizer steps: this rank's
    chunks of the solutions (n_local, 1+t) and probes (n_local, t), the
    UNBOUND DistPreconditioner (L sharded, chol_inner/sigma2 replicated),
    and the SLQ logdet of the last refresh, carried through warm steps."""

    solutions: torch.Tensor
    probes: torch.Tensor
    precond: DistPreconditioner
    logdet: torch.Tensor


class WarmMLLStepFns(NamedTuple):
    """Step functions returned by `make_warm_mll_step`; all return
    (loss, aux, grads, state) with aux the replicated `MLLAux` (logdet,
    quad, cg_iterations, rel_residual, and the MVMs the loop ran)."""

    cold: Callable     # (X, y, params, generator, probes=None)
    refresh: Callable  # (X, y, params, generator, state, probes=None)
    warm: Callable     # (X, y, params, generator, state)


def make_warm_mll_step(mesh, geom: DistGeometry, cfg: DistMLLConfig, *,
                       warm_min_iters: int = 1) -> WarmMLLStepFns:
    """The distributed stateful training engine: explicit-gradient MLL steps
    that carry a DistSolveState across optimizer steps (paper Eq. 2 from
    the forward's saved solves via `dist_mll_backward`). The refresh
    schedule lives host-side in `repro_torch.train.solver_state`.

    warm_min_iters: min CG iterations on WARM steps (cold/refresh keep
    cfg.min_cg_iters: at the paper's tol 1, a zero start needs a floor to
    do any work; a warm start begins from a meaningful x0).
    """
    _check_mesh(mesh, geom)
    g_value = -1.0 / geom.n

    def _run(X, y_loc, params, generator, *, precond, probes, x0,
             logdet_carry, min_iters):
        op = ShardedOperator(cfg.operator_config(geom), X, params)
        if precond is None:
            precond = op.preconditioner(cfg.precond_rank)
        (value, aux), (_, u_y, U, pinv_z), st = operator_mll_forward(
            op, y_loc, generator,
            precond_rank=cfg.precond_rank, num_probes=cfg.num_probes,
            max_cg_iters=cfg.max_cg_iters, min_cg_iters=min_iters,
            cg_tol=cfg.cg_tol, pcg_method=cfg.pcg_method,
            precond=precond, probes=probes, x0=x0, logdet_carry=logdet_carry)
        _, _, g_params = dist_mll_backward(geom, cfg, X, params, u_y, U,
                                           pinv_z, g_value, need_x=False)
        state = DistSolveState(solutions=st.solutions, probes=st.probes,
                               precond=precond.pre, logdet=aux.logdet)
        return -value / geom.n, aux, g_params, state

    def cold(X, y_loc, params, generator, probes=None):
        return _run(X, y_loc, params, generator, precond=None, probes=probes,
                    x0=None, logdet_carry=None, min_iters=cfg.min_cg_iters)

    def refresh(X, y_loc, params, generator, state, probes=None):
        # fresh precond + probes (so SLQ is re-estimated), but the y column
        # still warm-starts from the previous solve
        sol = state.solutions
        x0 = torch.cat([sol[:, :1], sol.new_zeros((sol.shape[0],
                                                   cfg.num_probes))], dim=1)
        return _run(X, y_loc, params, generator, precond=None, probes=probes,
                    x0=x0, logdet_carry=None, min_iters=cfg.min_cg_iters)

    def warm(X, y_loc, params, generator, state):
        pre = _BoundDistPreconditioner(geom, state.precond)
        return _run(X, y_loc, params, generator, precond=pre,
                    probes=state.probes, x0=state.solutions,
                    logdet_carry=state.logdet, min_iters=warm_min_iters)

    return WarmMLLStepFns(cold=cold, refresh=refresh, warm=warm)


def make_mean_cache_solve(mesh, geom: DistGeometry, cfg: DistMLLConfig, *,
                          tol: float = 0.01, max_iters: int = 400,
                          min_iters: int = 10):
    """(X, y_loc, params) -> (a (n,), rel_residual): the tight-tolerance
    solve a = K_hat^{-1} (y - mu), gathered to every rank (prediction then
    runs on one device, per the paper). `min_iters = max_iters` runs a
    fixed trip count (the dry run's cells)."""
    _check_mesh(mesh, geom)

    def fn(X, y_loc, params):
        op = ShardedOperator(cfg.operator_config(geom), X, params)
        yc = y_loc - constant_mean(params)
        if op.local_mask is not None:
            yc = yc * op.local_mask
        precond = op.preconditioner(cfg.precond_rank)
        res = pcg(op, yc[:, None], precond.solve, max_iters=max_iters,
                  min_iters=min_iters, tol=tol)
        a_full = _all_gather(mesh, geom.vector_pspec()[0], res.solution[:, 0])
        return a_full[:geom.n], res.rel_residual

    return fn


def shard_vector(mesh, geom: DistGeometry, y) -> torch.Tensor:
    """This rank's chunk of a full (n or n_padded, ...) array, on the mesh's
    device (a full-length array is padded first)."""
    _check_mesh(mesh, geom)
    y = torch.as_tensor(y)
    if y.shape[0] == geom.n:
        y = pad_to_geometry(geom, y)
    c = _chunk_index(geom)
    return y[c * geom.n_local:(c + 1) * geom.n_local].to(mesh.device).contiguous()


def replicate(mesh, x):
    """The full array (or params tree) on this rank's device."""
    if isinstance(x, tuple):
        return params_map(lambda a: torch.as_tensor(a).to(mesh.device), x)
    return torch.as_tensor(x).to(mesh.device)


def collective_bench_fns(mesh, geom: DistGeometry) -> dict:
    """Micro-bench bodies for the mesh's two collective primitives.

    Returns name -> fn(V_loc) -> V' on a CG-vector chunk (n_local, t):

      * "ppermute_ring" — ONE +1 hop along the first multi-rank row axis:
        the unit transfer of `_chunked_contraction`'s overlap pipeline.
      * "psum_scatter"  — the 2-D scheme's closing reduce-scatter over the
        col axes, fed a tiled stand-in for the row partials.

    Axes with a single rank contribute no transfer and are omitted; on a
    one-rank mesh the dict is empty.
    """
    _check_mesh(mesh, geom)
    fns: dict[str, Callable] = {}
    ring_axes = [(i, s) for i, s in enumerate(geom.row_sizes) if s > 1]
    if ring_axes:
        name = geom.row_axes[ring_axes[0][0]]

        def ring_hop(v_loc):
            v_loc = v_loc.contiguous()
            out = torch.empty_like(v_loc)
            for w in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, v_loc, mesh.shifted_rank(name, 1)),
                    dist.P2POp(dist.irecv, out, mesh.shifted_rank(name, -1))]):
                w.wait()
            return out

        fns["ppermute_ring"] = ring_hop
    if geom.col_axes and geom.d_col > 1:
        def scatter(v_loc):
            return _reduce_scatter(mesh, geom.col_axes,
                                   v_loc.repeat(geom.d_col, 1))

        fns["psum_scatter"] = scatter
    return fns


__all__ = [
    "DistGeometry", "DistMLLConfig", "DistPreconditioner", "DistSolveState",
    "ShardedOperator", "WarmMLLStepFns", "collective_bench_fns",
    "dist_kmvm", "dist_mll_backward", "dist_pivoted_cholesky",
    "make_dist_mll", "make_dist_preconditioner", "make_geometry",
    "make_mean_cache_solve", "make_mll_value_and_grad", "make_warm_mll_step",
    "pad_to_geometry", "replicate", "shard_vector",
]
