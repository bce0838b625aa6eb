"""`blocksparse` — the distance-pruned KernelOperator backend.

The counterpart of `repro.sparse.blocksparse`, registered lazily in the
operator registry. The operator executes a `SparsePlan`:

  * `matvec` permutes V into the plan's Morton order, runs only the active
    tile pairs and permutes back, so it is externally identical to the
    dense backends. When the whole spec is one fused pass
    (`kernels.ops.fused_pass_or_none`, the reference's rule), the pairs run
    in ONE launch of the block-sparse CUDA kernel (`kmvm_blocksparse`; its
    plain version on a CPU tensor), fp32-accumulated bf16 tiles under
    `compute_dtype="bfloat16"`. Other specs (ARD lengthscales, `linear`
    factors) take the masked path, `masked_kmvm`, on any device, as they
    do on the TPU.
  * `quad_form_grads`, the Eq. 2 backward surface, walks the same row
    structure with torch autograd, one gathered slab and its residuals at
    a time (`sparse_quad_form_partials`). Pruned tiles contribute exactly
    zero gradient (the Wendland taper is zero, with zero slope, beyond its
    support).
  * `cross_matvec` prunes at predict time with a runtime test: the query
    chunk's bounding box against every tile's box at the CURRENT support
    radius, computed on the device. The active X tiles form one column list
    shared by every 64-row tile of the chunk, and the whole chunk is one
    launch of the same block-sparse kernel (no loop over tiles), with the
    list cut into fixed segments so that a short chunk still fills the
    card. Its rows sum their column tiles in ascending order and a tile of
    zeros adds exactly nothing, so a query's result is the same bits
    whatever chunk it is served in (the engine's sorted, chunked
    predictions equal the unchunked ones). The chunk's tile list is read
    to the host (the `sparse_tile_count` and `sparse_tile_list` read
    spans), where its CSR is built (`_cross_csr`, the `sparse_csr` host
    span).

When `OperatorConfig.plan` is None the operator builds one at construction
and records it on its config, so posterior artifacts capture the plan the
operator executed.

The distributed composition, `dist_blocksparse_kmvm`, runs the same kernel
inside the sharded operator's row layout (pre-sorted data, whole tiles per
rank); `validate_dist_plan` checks that contract.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.kernels_math import (
    kernel_matrix,
    noise_variance,
    params_leaves,
    params_unflatten,
)
from repro_torch.core.operators import (
    KernelOperator,
    OperatorConfig,
    _compute_dtype_of,
    mixed_block_fn,
    register_operator,
)
from repro_torch.core.partitioned import block_quad_grads
from repro_torch.kernels.ops import (
    _pass_scalar_vector,
    _prescale,
    _scale_rhs,
    fused_pass_or_none,
)

from .kmvm_sparse import kmvm_blocksparse, longest_row_first, tile_rows
from .plan import SparsePlan, build_plan, chunk_sliced_plan, spec_support_radius

_QUERY_TILE = 64     # rows per tile of a query chunk in `cross_matvec`
_SEGMENT_TILES = 32  # plan tiles per column segment of `cross_matvec`


def _cross_csr(tiles: np.ndarray, m: int):
    """The CSR of a query chunk's launch, on the host (a `sparse_csr` host
    span): every 64-row query tile of the chunk's m rows against the active
    column tiles, the list cut into segments of _SEGMENT_TILES consecutive
    plan tiles (boundaries fixed in the plan's tile order, so they do not
    depend on the chunk), each segment a separate copy of the query rows.
    Returns (segments, row_ptr, cols, launch order: longest row first)."""
    with obs.host_span("sparse_csr"):
        q = -(-m // _QUERY_TILE)
        segs, starts = np.unique(tiles // _SEGMENT_TILES, return_index=True)
        bounds = np.append(starts, tiles.shape[0])
        cols = np.concatenate([np.tile(tiles[a:b], q)
                               for a, b in zip(bounds[:-1], bounds[1:])])
        row_ptr = np.concatenate([[0], np.cumsum(np.repeat(np.diff(bounds), q))])
        return len(segs), row_ptr, cols, longest_row_first(row_ptr)


def _inner_block_fn(kernel, compute_dtype) -> Callable:
    """Per-slab K(Xb, Xc) @ Vc: the mixed evaluator when a compute dtype is
    set, the exact dense slab otherwise."""
    if compute_dtype is not None:
        return mixed_block_fn(kernel, compute_dtype)

    def exact(Xb, Xc, Vc, params):
        return kernel_matrix(kernel, Xb, Xc, params) @ Vc

    return exact


def _row_columns(plan: SparsePlan, cols: torch.Tensor, r: int) -> torch.Tensor:
    """Sorted point indices of row tile r's active column tiles."""
    return tile_rows(cols[int(plan.row_ptr[r]):int(plan.row_ptr[r + 1])],
                     plan.tile, plan.n)


def masked_kmvm(kernel, Xs, Vs, params, plan: SparsePlan, *,
                compute_dtype=None) -> torch.Tensor:
    """K_sorted @ V_sorted over active tiles only, for specs the fused pass
    cannot express: one gathered (tile, active columns) slab per row tile,
    so the work is the pair count and one slab is live at a time."""
    inner = _inner_block_fn(kernel, compute_dtype)
    cols = torch.as_tensor(plan.pair_cols, device=Xs.device)
    out = torch.empty_like(Vs)
    for r in range(plan.num_tiles):
        i0, i1 = r * plan.tile, min((r + 1) * plan.tile, plan.n)
        idx = _row_columns(plan, cols, r)
        out[i0:i1] = inner(Xs[i0:i1], Xs[idx], Vs[idx], params).to(Vs.dtype)
    return out


def fused_operands(ppass, Xs, Vs, compute_dtype=None):
    """(Xp, Vp, scalars): the block-sparse kernel's operands for one fused
    pass — inputs pre-scaled by the pass's lengthscale, the RHS by its base
    weight, both in the compute dtype (fp32 unless bf16 is asked for)."""
    cdt = torch.float32 if compute_dtype is None else compute_dtype
    return (_prescale(ppass, Xs, cdt), _scale_rhs(ppass, Vs, cdt),
            _pass_scalar_vector(ppass, Xs.device))


def sorted_fused_kmvm(ppass, Xs, Vs, row_ptr, cols, *, tile: int,
                      compute_dtype=None, row_order=None) -> torch.Tensor:
    """One fused pass over the active pairs on pre-sorted operands (the
    counterpart of `pallas_sorted_kmvm`): (n, t) fp32; `row_order`: the
    plan's launch order (`SparsePlan.row_order`)."""
    Xp, Vp, scalars = fused_operands(ppass, Xs, Vs, compute_dtype)
    return kmvm_blocksparse(ppass.components, Xp, Xp, Vp, scalars, row_ptr,
                            cols, tile=tile, row_order=row_order)


def sparse_quad_form_partials(kernel, Xs, A, V, params, plan: SparsePlan):
    """Gradients of q = sum_j a_j^T K_sorted v_j over ACTIVE tiles only:
    (g_params, g_X_sorted). Per row tile, torch autograd of one gathered
    slab (freed before the next); column gradients are scattered back to
    the gathered rows."""
    leaves = [a.detach().requires_grad_(True) for a in params_leaves(params)]
    g_acc = [torch.zeros_like(a) for a in leaves]
    gX = torch.zeros_like(Xs)
    cols = torch.as_tensor(plan.pair_cols, device=Xs.device)
    A, V = A.detach(), V.detach()
    for r in range(plan.num_tiles):
        i0, i1 = r * plan.tile, min((r + 1) * plan.tile, plan.n)
        idx = _row_columns(plan, cols, r)
        gl, gxb, gxc = block_quad_grads(kernel, params, leaves, Xs[i0:i1],
                                        Xs[idx], A[i0:i1], V[idx])
        g_acc = [a + b for a, b in zip(g_acc, gl)]
        gX.index_add_(0, idx, gxc)
        gX[i0:i1] += gxb
    return params_unflatten(params, g_acc), gX


@register_operator("blocksparse")
class BlockSparseOperator(KernelOperator):
    """Distance-pruned MVMs for compactly-supported kernel specs.

    Non-compact specs plan to the all-active mask — every tile pair runs
    and results match the other backends — so the backend is safe to
    select for any spec and pays off once a Wendland taper enters it.
    """

    grad_backend = "blocksparse"

    def __init__(self, config: OperatorConfig, X: torch.Tensor, params):
        plan = config.plan
        if plan is None:
            plan = build_plan(config.kernel, X, params,
                              tile=max(8, min(config.row_block, 256)))
            config = config._replace(plan=plan)
        super().__init__(config, X, params)
        if not isinstance(plan, SparsePlan):
            raise TypeError(f"OperatorConfig.plan must be a SparsePlan, "
                            f"got {type(plan)}")
        if plan.n != X.shape[0]:
            raise ValueError(
                f"plan covers n={plan.n} rows but X has {X.shape[0]}")
        self.plan = plan
        dev = X.device
        self._perm = torch.as_tensor(plan.perm, device=dev).long()
        self._inv_perm = torch.as_tensor(plan.inv_perm, device=dev).long()
        self._row_ptr = torch.as_tensor(plan.row_ptr, device=dev)
        self._cols = torch.as_tensor(plan.pair_cols, device=dev)
        self._row_order = torch.as_tensor(plan.row_order, device=dev)
        self._Xs = X[self._perm]

    @classmethod
    def slab_block_fn(cls, config: OperatorConfig, operand_dtype):
        raise ValueError("'blocksparse' cannot be a per-slab inner backend")

    # -- the pruned MVM -----------------------------------------------------

    def _sorted_kmvm(self, Vs: torch.Tensor) -> torch.Tensor:
        cdt = _compute_dtype_of(self.config, self.dtype)
        ppass = fused_pass_or_none(self.config.kernel, self.params)
        if ppass is not None:
            out = sorted_fused_kmvm(ppass, self._Xs, Vs, self._row_ptr,
                                    self._cols, tile=self.plan.tile,
                                    compute_dtype=cdt,
                                    row_order=self._row_order)
            return out.to(Vs.dtype)
        return masked_kmvm(self.config.kernel, self._Xs, Vs, self.params,
                           self.plan, compute_dtype=cdt)

    def matvec(self, V: torch.Tensor) -> torch.Tensor:
        squeeze = V.ndim == 1
        if squeeze:
            V = V[:, None]
        out = self._sorted_kmvm(V[self._perm])[self._inv_perm]
        out = self._add_noise(out, V)
        return out[:, 0] if squeeze else out

    # -- prediction-time pruning --------------------------------------------

    def cross_matvec(self, Z: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
        """K(Z, X) @ V over the X tiles within the CURRENT support radius of
        the query chunk's bounding box (exact for any radius; the serving
        engine Morton-sorts queries so that chunks are spatially local)."""
        squeeze = V.ndim == 1
        if squeeze:
            V = V[:, None]
        plan = self.plan
        tiles = self._active_tiles(Z)
        m = Z.shape[0]
        if tiles.numel() == 0 or m == 0:
            out = torch.zeros((m, V.shape[1]), dtype=V.dtype, device=V.device)
            return out[:, 0] if squeeze else out
        cdt = _compute_dtype_of(self.config, self.dtype)
        ppass = fused_pass_or_none(self.config.kernel, self.params)
        Vs = V[self._perm]
        if ppass is not None:
            with obs.read_span("sparse_tile_list"):
                tiles = tiles.cpu().numpy()
            out = self._cross_fused(ppass, Z, Vs, tiles, cdt)
        else:
            idx = tile_rows(tiles, plan.tile, plan.n)
            out = _inner_block_fn(self.config.kernel, cdt)(
                Z, self._Xs[idx], Vs[idx], self.params)
        out = out.to(V.dtype)
        return out[:, 0] if squeeze else out

    def _active_tiles(self, Z: torch.Tensor) -> torch.Tensor:
        """int32 indices of the plan tiles within the current support
        radius of the bounding box of Z (every tile when not compact)."""
        plan = self.plan
        if not plan.compact:
            return torch.arange(plan.num_tiles, dtype=torch.int32,
                                device=Z.device)
        support = spec_support_radius(self.config.kernel, self.params)
        lo = torch.as_tensor(plan.box_lo, device=Z.device).to(Z.dtype)
        hi = torch.as_tensor(plan.box_hi, device=Z.device).to(Z.dtype)
        gap = torch.clamp(lo - torch.max(Z, 0).values, min=0.0)
        gap = torch.maximum(gap, torch.clamp(torch.min(Z, 0).values - hi,
                                             min=0.0))
        active = torch.sum(gap * gap, 1) < support * support
        with obs.read_span("sparse_tile_count"):  # nonzero reads its count
            tiles = torch.nonzero(active)[:, 0]
        return tiles.to(torch.int32)

    def cross_launch_operands(self, Z: torch.Tensor, V: torch.Tensor):
        """(args, kwargs) of the one `kmvm_blocksparse` launch that
        `cross_matvec(Z, V)` makes, for a spec that is one fused pass and a
        chunk with at least one active tile: what a check of the launch
        against `kmvm_blocksparse_plain` at the serving shape needs."""
        if V.ndim == 1:
            V = V[:, None]
        ppass = fused_pass_or_none(self.config.kernel, self.params)
        tiles = self._active_tiles(Z).cpu().numpy()
        return self._cross_operands(ppass, Z, V[self._perm],
                                    _cross_csr(tiles, Z.shape[0]),
                                    _compute_dtype_of(self.config, self.dtype))

    def _cross_operands(self, ppass, Z, Vs, csr, cdt):
        """The launch's operands for a query chunk and its CSR (`_cross_csr`):
        the query rows pre-scaled, padded to whole 64-row tiles and copied
        once per column segment, so a short chunk still fills the card."""
        nseg, row_ptr, cols, order = csr
        m = Z.shape[0]
        dev = Z.device
        Xp, Vp, scalars = fused_operands(ppass, self._Xs, Vs, cdt)
        Zp = _prescale(ppass, Z, Xp.dtype)
        if m % _QUERY_TILE:  # each segment's copy starts on a tile boundary
            pad = -(-m // _QUERY_TILE) * _QUERY_TILE - m
            Zp = torch.cat([Zp, Zp.new_zeros((pad, Zp.shape[1]))])
        return ((ppass.components, Zp.repeat(nseg, 1), Xp, Vp, scalars,
                 torch.as_tensor(row_ptr, dtype=torch.int32, device=dev),
                 torch.as_tensor(cols, dtype=torch.int32, device=dev)),
                {"tile": self.plan.tile, "row_tile": _QUERY_TILE,
                 "row_order": torch.as_tensor(order, device=dev)})

    def _cross_fused(self, ppass, Z, Vs, tiles: np.ndarray, cdt):
        """One block-sparse launch for a query chunk (`_cross_operands`);
        the per-segment partials are summed in segment order. A segment
        whose tiles all contribute zero for a row adds exactly zero, so a
        row's bits do not depend on the chunk it is served in."""
        csr = _cross_csr(tiles, Z.shape[0])
        args, kwargs = self._cross_operands(ppass, Z, Vs, csr, cdt)
        m, nseg = Z.shape[0], csr[0]
        part = kmvm_blocksparse(*args, **kwargs).view(nseg, -1, Vs.shape[1])
        out = part[0]
        for s in range(1, nseg):  # in segment order, for any chunk
            out = out + part[s]
        return out[:m]

    # -- Eq. 2 backward surface ---------------------------------------------

    def quad_form_grads(self, A: torch.Tensor, V: torch.Tensor,
                        need_x: bool = True):
        del need_x  # g_X comes with the partials either way
        if A.ndim == 1:
            A = A[:, None]
        if V.ndim == 1:
            V = V[:, None]
        gp, gXs = sparse_quad_form_partials(
            self.config.kernel, self._Xs, A[self._perm], V[self._perm],
            self.params, self.plan)
        return self._add_noise_grad(gp, A, V), gXs[self._inv_perm]


# ---------------------------------------------------------------------------
# distributed composition: each rank owns the mask slice of its tile
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _rows_csr(plan: SparsePlan, r0: int, r1: int, device: str):
    """(row_ptr, cols, row_order) int32 on `device`: the CSR of plan row
    tiles [r0, r1), offsets rebased to 0, and its launch order."""
    rp = plan.row_ptr
    ptr = (rp[r0:r1 + 1] - rp[r0]).astype(np.int32)
    cols = plan.pair_cols[rp[r0]:rp[r1]].astype(np.int32)
    return (torch.as_tensor(ptr, device=device),
            torch.as_tensor(cols, device=device),
            torch.as_tensor(longest_row_first(ptr), device=device))


@functools.lru_cache(maxsize=64)
def _chunk_csrs(plan: SparsePlan, n_chunks: int, r0: int, r1: int,
                device: str) -> tuple:
    """Per global vector chunk c: (row_ptr, cols, row_order) int32 on
    `device` of plan row tiles [r0, r1) against the chunk's own tiles
    (in-chunk indices, ascending) — `chunk_sliced_plan` in the block-sparse
    kernel's CSR form, with its launch order."""
    sl = chunk_sliced_plan(plan, n_chunks)
    out = []
    for c in range(n_chunks):
        valid = sl.valid[r0:r1, c]
        counts = valid.sum(axis=1)
        ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        cols = sl.cols[r0:r1, c][valid].astype(np.int32)
        out.append((torch.as_tensor(ptr, device=device),
                    torch.as_tensor(cols, device=device),
                    torch.as_tensor(longest_row_first(ptr), device=device)))
    return tuple(out)


def _local_rows_kmvm(kernel, params, x_rows, x_cols, v, ppass, row_ptr, cols,
                     row_order, tile, compute_dtype):
    """K(x_rows, x_cols) @ v over the CSR's active tiles: one block-sparse
    launch (fp32 out) when the spec is one fused pass, else one gathered
    slab per row tile."""
    if ppass is not None:
        Xp = _prescale(ppass, x_rows, torch.float32 if compute_dtype is None
                       else compute_dtype)
        Xc, Vc, scalars = fused_operands(ppass, x_cols, v, compute_dtype)
        return kmvm_blocksparse(ppass.components, Xp, Xc, Vc, scalars,
                                row_ptr, cols, tile=tile, row_order=row_order)
    inner = _inner_block_fn(kernel, compute_dtype)
    out = v.new_empty((x_rows.shape[0], v.shape[1]))
    rp = row_ptr.tolist()
    for r in range(len(rp) - 1):
        idx = tile_rows(cols[rp[r]:rp[r + 1]], tile, x_cols.shape[0])
        out[r * tile:(r + 1) * tile] = inner(
            x_rows[r * tile:(r + 1) * tile], x_cols[idx], v[idx],
            params).to(v.dtype)
    return out


def dist_blocksparse_kmvm(geom, kernel, X: torch.Tensor, V_local: torch.Tensor,
                          params, plan: SparsePlan, *,
                          add_noise: bool = True, noise_floor: float = 1e-4,
                          compute_dtype=None,
                          overlap: bool | None = None) -> torch.Tensor:
    """Distance-pruned distributed MVM — 1-D or (rows x cols) 2-D mesh.

    Contract (validated by ShardedOperator): X and the CG vectors are
    PRE-SORTED in Morton order (plan built with assume_sorted=True on the
    PADDED X, so perm is the identity) and every per-rank vector chunk holds
    whole plan tiles (make_geometry(..., tile_multiple=plan.tile)).

    1-D serial: one all-gather of V, then ONE block-sparse launch over this
    rank's slice of the plan's row tiles. On column axes (2-D) or with
    overlap the MVM runs as the dense engine's chunked contraction: per
    source chunk, one launch against that chunk's own CSR (the in-chunk
    active col tiles of `chunk_sliced_plan`), added into the partial, so the
    per-step work stays fill-proportional on the mesh. Only the FORWARD
    MVMs are pruned; `ShardedOperator.quad_form_grads` keeps the dense
    blockwise partials, as the reference does.
    """
    from repro_torch.core.distributed import (
        _all_gather, _chunk_mask, _chunked_contraction, _linear_index,
        _mesh, _reduce_scatter)

    squeeze = V_local.ndim == 1
    if squeeze:
        V_local = V_local[:, None]
    overlap = geom.overlap if overlap is None else overlap
    mesh = _mesh(geom)
    ppass = fused_pass_or_none(kernel, params)
    tile = plan.tile
    dev = str(X.device)

    mask = _chunk_mask(geom, V_local.dtype)
    Vk = V_local if mask is None else V_local * mask[:, None]
    i = _linear_index(mesh, geom.row_axes)
    T_rloc = geom.rows_local // tile
    r0, r1 = i * T_rloc, (i + 1) * T_rloc
    x_rows = X[i * geom.rows_local:(i + 1) * geom.rows_local]

    if geom.col_axes or overlap:
        csrs = _chunk_csrs(plan, geom.d_row * geom.d_col, r0, r1, dev)

        def chunk_fn(c, v, partial):
            x_c = X[c * geom.n_local:(c + 1) * geom.n_local]
            out = _local_rows_kmvm(kernel, params, x_rows, x_c, v, ppass,
                                   *csrs[c], tile, compute_dtype)
            return out if partial is None else partial + out

        partial_rows = _chunked_contraction(geom, chunk_fn, Vk,
                                            overlap=overlap)
        out = _reduce_scatter(mesh, geom.col_axes,
                              partial_rows.to(V_local.dtype))
    else:
        v_full = _all_gather(mesh, geom.row_axes, Vk)
        out = _local_rows_kmvm(kernel, params, x_rows, X, v_full, ppass,
                               *_rows_csr(plan, r0, r1, dev), tile,
                               compute_dtype).to(V_local.dtype)
    if mask is not None:
        out = out * mask[:, None]
    if add_noise:
        out = out + noise_variance(params, noise_floor) * V_local
    return out[:, 0] if squeeze else out


def validate_dist_plan(geom, plan: SparsePlan) -> None:
    """The sharded-composition contract (raise early, at config time)."""
    if not np.array_equal(plan.perm, np.arange(plan.n)):
        raise ValueError(
            "distributed blocksparse needs PRE-SORTED data: Morton-sort "
            "X/y first and build the plan with assume_sorted=True")
    if plan.n != geom.n_padded or plan.n_pad != plan.n:
        raise ValueError(
            f"plan covers n={plan.n} rows but the geometry lays out "
            f"{geom.n_padded} (pad X to geom.n_padded with "
            f"distributed.pad_to_geometry, then build the plan on the "
            f"padded data so it holds whole tiles)")
    if geom.n_local % plan.tile:
        raise ValueError(
            f"per-rank chunk ({geom.n_local}) must hold whole plan tiles "
            f"({plan.tile}): build the geometry with "
            f"tile_multiple={plan.tile}")
