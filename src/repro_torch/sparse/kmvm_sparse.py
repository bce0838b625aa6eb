"""The block-sparse fused kernel-MVM (B4): the CUDA kernel and its plain
PyTorch version.

    kmvm_blocksparse   out[rows of tile r] = sum over the active column
                       tiles c of row tile r of K_fused(Xi_r, Xj_c) @ V_c
                       (replaces `repro.sparse.kmvm_sparse.
                       kmvm_blocksparse_pallas`; kernel in
                       `repro_torch/kernels/csrc/kmvm_sparse.cu`)

K_fused is the dense kernels' fused kernel sum (`kernels.kmvm`): inputs
pre-scaled by the pass's reference lengthscale, V by its base weight,
operands fp32 or bf16, fp32 math and outputs, the component scalars in
`kmvm.scalar_layout` order. The sparsity pattern is the plan's sorted pair
list in CSR form: `row_ptr` (T + 1,) int32 offsets and `cols` (P,) int32
column tiles (`SparsePlan.row_ptr`, `SparsePlan.pair_cols`). The training
MVM passes the sorted points as both Xi and Xj (tiles of the plan's size);
the prediction-time cross-covariance passes a query chunk as Xi, in row
tiles of its own size. Nothing is padded to whole tiles: last tiles may be
ragged.

The kernel launches the row tiles longest first: `longest_row_first`
orders them by descending CSR degree (ties in plan order), once per plan
(`SparsePlan.row_order`), and the caller passes that order as `row_order`.
A block's work and summation order do not depend on when it runs, so the
order changes no bits; None launches in plan order.

The wrapper dispatches on where its tensors lie: a CPU tensor goes to the
plain version, a CUDA tensor to the kernel or an exception. `launch_counts`
counts the kernel's launches.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.kmvm import (
    _check_launch,
    _spec_array,
    kmvm_plain,
)

_count_lock = threading.Lock()
launch_counts = {"kmvm_blocksparse": 0}


def reset_launch_counts() -> None:
    with _count_lock:
        for k in launch_counts:
            launch_counts[k] = 0


def _count(name: str) -> None:
    """One launch of `name`; batcher workers launch from several threads,
    and `+=` on a dict entry is not atomic."""
    with _count_lock:
        launch_counts[name] += 1


def longest_row_first(row_ptr) -> np.ndarray:
    """The row tiles of a CSR (row_ptr (T + 1,), host) by descending degree,
    ties in ascending row order: (T,) int32, the kernel's launch order."""
    degree = np.diff(np.asarray(row_ptr, dtype=np.int64))
    return np.argsort(-degree, kind="stable").astype(np.int32)


def tile_rows(tiles: torch.Tensor, tile: int, n: int) -> torch.Tensor:
    """The point indices of the given tiles, in order (the last tile cut
    at n)."""
    idx = (tiles.to(torch.int64)[:, None] * tile
           + torch.arange(tile, device=tiles.device)).reshape(-1)
    return idx[idx < n]


def kmvm_blocksparse_plain(components, Xi, Xj, V, scalars, row_ptr, cols, *,
                           tile: int, row_tile: int | None = None,
                           row_order=None):
    """Plain PyTorch version: one gathered (row tile, active columns) slab
    per row tile through `kmvm_plain` (the dense kernels' plain version).
    `row_order` (the kernel's launch order) does not change the result."""
    row_tile = tile if row_tile is None else row_tile
    m, n = Xi.shape[0], Xj.shape[0]
    out = torch.empty((m, V.shape[1]), dtype=torch.float32, device=Xi.device)
    rp = row_ptr.tolist()
    cols = cols.to(Xi.device)
    for r in range(len(rp) - 1):
        i0, i1 = r * row_tile, min((r + 1) * row_tile, m)
        idx = tile_rows(cols[rp[r]:rp[r + 1]], tile, n)
        out[i0:i1] = kmvm_plain(components, Xi[i0:i1], Xj[idx], V[idx], scalars)
    return out


def kmvm_blocksparse(components, Xi, Xj, V, scalars, row_ptr, cols, *,
                     tile: int, row_tile: int | None = None,
                     row_order: torch.Tensor | None = None) -> torch.Tensor:
    """Block-sparse fused [sum_c w_c prod_f phi(q d2)] @ V -> (m, t) fp32.

    Xi (m, d) rows in tiles of `row_tile` (default `tile`), Xj (n, d) and
    V (n, t) columns in tiles of `tile`, one operand dtype (fp32 or bf16);
    scalars (L,) fp32; row_ptr (ceil(m / row_tile) + 1,) and cols (P,)
    int32, each row's column tiles ascending; row_order (ceil(m /
    row_tile),) int32, a permutation of the row tiles, the launch order
    (`longest_row_first`; None: plan order). Any tile sizes, m, n, d, t.
    """
    row_tile = tile if row_tile is None else row_tile
    if Xi.device.type == "cpu":
        return kmvm_blocksparse_plain(components, Xi, Xj, V, scalars, row_ptr,
                                      cols, tile=tile, row_tile=row_tile)
    dtype_code = _check_launch(components, scalars, (Xi, Xj, V))
    m, d = Xi.shape
    n, t = V.shape
    num_row_tiles = -(-m // row_tile)
    index_arrays = [("row_ptr", row_ptr), ("cols", cols)]
    if row_order is not None:
        index_arrays.append(("row_order", row_order))
    for name, a in index_arrays:
        if a.device != Xi.device or a.dtype != torch.int32 \
                or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{Xi.device}, got {a.dtype} on {a.device}")
    if row_ptr.shape != (num_row_tiles + 1,):
        raise ValueError(f"row_ptr {tuple(row_ptr.shape)} does not match "
                         f"{num_row_tiles} row tiles of {row_tile} rows")
    if row_order is not None and row_order.shape != (num_row_tiles,):
        raise ValueError(f"row_order {tuple(row_order.shape)} does not match "
                         f"{num_row_tiles} row tiles")
    out = torch.empty((m, t), dtype=torch.float32, device=Xi.device)
    if m == 0 or t == 0:
        return out
    lib = build.library()
    code = lib.kmvm_bs_fwd(
        dtype_code, Xi.data_ptr(), Xj.data_ptr(), V.data_ptr(),
        scalars.data_ptr(), _spec_array(components), scalars.shape[0],
        row_ptr.data_ptr(), cols.data_ptr(),
        None if row_order is None else row_order.data_ptr(), out.data_ptr(),
        num_row_tiles,
        m, n, d, t, row_tile, tile,
        torch.cuda.current_stream(Xi.device).cuda_stream)
    if code != 0:
        msg = lib.kmvm_bs_error_string(code).decode()
        raise RuntimeError(f"kmvm_blocksparse launch failed: CUDA error "
                           f"{code} ({msg})")
    _count("kmvm_blocksparse")
    return out
