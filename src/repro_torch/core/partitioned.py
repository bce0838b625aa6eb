"""Partitioned kernel matrix-multiplies — the paper's core memory mechanism.

`K_hat @ V` in row partitions: for each block of rows X^(l) only the
(row_block, n) slab `K_{X^(l) X}` is built, multiplied into V and dropped,
so peak memory is O(row_block * n). PyTorch runs the loop eagerly, so one
slab is live at a time by construction. The per-slab MVM can be routed to
the fused CUDA kernel (`repro_torch.kernels.ops.pallas_block_fn`), which
never builds the slab in device memory at all.

The training backward, `quad_form_partials`, keeps the same bound: torch
autograd runs per row block, and one slab with its residuals is live at a
time.
"""

from __future__ import annotations

from typing import Callable

import torch

from .kernels_math import (
    kernel_matrix,
    noise_variance,
    params_leaves,
    params_unflatten,
)


def pad_rows(A: torch.Tensor, multiple: int) -> tuple[torch.Tensor, int]:
    """Zero-pad axis 0 of A up to a multiple; returns (padded, n_pad)."""
    n = A.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return A, 0
    pad = torch.zeros((rem,) + tuple(A.shape[1:]), dtype=A.dtype, device=A.device)
    return torch.cat([A, pad], dim=0), rem


def map_row_chunks(fn, Z: torch.Tensor, chunk_size: int):
    """Apply `fn` to fixed-shape row chunks of Z; concatenate, strip padding.

    Z is zero-padded up to a multiple of `chunk_size`, so every call sees the
    same (chunk_size, ...) shape (the serving engine's fixed launch shape).
    `fn` may return a tensor or a tuple of tensors whose leading axis is the
    chunk axis. Nothing (n_rows, n)-sized is ever live at once.
    """
    n = Z.shape[0]
    Zp, _ = pad_rows(Z, chunk_size)
    if Zp.shape[0] == 0:  # empty query: one all-padding chunk, sliced to 0
        Zp = torch.zeros((chunk_size,) + tuple(Z.shape[1:]), dtype=Z.dtype,
                         device=Z.device)
    outs = [fn(Zp[i:i + chunk_size]) for i in range(0, Zp.shape[0], chunk_size)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(xs, dim=0)[:n] for xs in zip(*outs))
    return torch.cat(outs, dim=0)[:n]


def default_row_block(n: int, d: int, t: int, hbm_budget_bytes: int = 2 << 30) -> int:
    """A row block whose transient (rb, n) fp32 slab fits the budget (2 GiB
    by default, of the card's memory), clamped to [128, 8192] and rounded
    to a multiple of 128, as the reference's."""
    del d, t
    rb = hbm_budget_bytes // max(n * 4, 1)
    rb = max(128, min(int(rb), 8192))
    return (rb // 128) * 128


def _block_kmvm_dense(kernel, Xb, X, V, params):
    """One row-partition's contribution: K(Xb, X) @ V, slab materialized."""
    return kernel_matrix(kernel, Xb, X, params) @ V


def kmvm_rect(
    kernel,
    X_rows: torch.Tensor,
    X_cols: torch.Tensor,
    V: torch.Tensor,
    params,
    *,
    row_block: int = 1024,
    block_fn: Callable | None = None,
) -> torch.Tensor:
    """K(X_rows, X_cols) @ V in row partitions; no noise term."""
    inner = block_fn if block_fn is not None else (
        lambda Xb, X, Vb, p: _block_kmvm_dense(kernel, Xb, X, Vb, p))
    outs = [inner(X_rows[i:i + row_block], X_cols, V, params)
            for i in range(0, X_rows.shape[0], row_block)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def kmvm(
    kernel,
    X: torch.Tensor,
    V: torch.Tensor,
    params,
    *,
    row_block: int = 1024,
    add_noise: bool = True,
    noise_floor: float = 1e-4,
    block_fn: Callable | None = None,
) -> torch.Tensor:
    """O(n)-memory K_hat @ V via partitioned row blocks; V is (n, t) or (n,)."""
    squeeze = V.ndim == 1
    if squeeze:
        V = V[:, None]
    out = kmvm_rect(kernel, X, X, V, params, row_block=row_block,
                    block_fn=block_fn)
    if add_noise:
        out = out + noise_variance(params, noise_floor) * V
    return out[:, 0] if squeeze else out


def quad_form(kernel, X: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
              params, *, row_block: int = 1024, add_noise: bool = True,
              noise_floor: float = 1e-4) -> torch.Tensor:
    """sum_j a_j^T K_hat b_j for column-paired A, B of shape (n, t) (or
    (n,)): the differentiable surface the BBMM backward contracts against,
    O(row_block * n) memory."""
    if A.ndim == 1:
        A = A[:, None]
    if B.ndim == 1:
        B = B[:, None]
    KB = kmvm(kernel, X, B, params, row_block=row_block, add_noise=add_noise,
              noise_floor=noise_floor)
    return torch.sum(A * KB)


def kernel_rows(kernel, X: torch.Tensor, idx: torch.Tensor, params) -> torch.Tensor:
    """K(X[idx], X): O(|idx| * n)."""
    return kernel_matrix(kernel, X[idx], X, params)


def block_quad_grads(kernel, params, leaves, Xb, Xc, Ab, Vc):
    """Autograd of one block's sum(Ab o (K(Xb, Xc) @ Vc)) w.r.t. the params
    leaves, Xb and Xc: (g_leaves, g_Xb, g_Xc). `leaves` are
    `params_leaves(params)` detached with requires_grad. The block's graph
    is freed before it returns."""
    Xb = Xb.detach().requires_grad_(True)
    Xc = Xc.detach().requires_grad_(True)
    with torch.enable_grad():  # also inside an autograd backward
        K = kernel_matrix(kernel, Xb, Xc, params_unflatten(params, leaves))
        q = torch.sum(Ab * (K @ Vc))
        g = torch.autograd.grad(q, leaves + [Xb, Xc], allow_unused=True)
    g_leaves = [torch.zeros_like(a) if gi is None else gi
                for a, gi in zip(leaves, g[:-2])]
    return g_leaves, g[-2], g[-1]


def quad_form_partials(kernel, X_rows, X_cols, A, V, params, *,
                       row_block: int = 1024):
    """Gradients of q = sum_j a_j^T K(X_rows, X_cols) v_j (no noise term)
    w.r.t. (params, X_rows, X_cols): (g_params, g_rows, g_cols).

    A row-block loop of torch autograd: each block builds its slab and
    residuals once for all t column pairs (so callers batch columns rather
    than call twice) and frees them before the next, so peak memory is
    O(row_block * n).
    """
    if A.ndim == 1:
        A = A[:, None]
    if V.ndim == 1:
        V = V[:, None]
    leaves = [a.detach().requires_grad_(True) for a in params_leaves(params)]
    g_acc = [torch.zeros_like(a) for a in leaves]
    g_rows = torch.zeros_like(X_rows)
    g_cols = torch.zeros_like(X_cols)
    V = V.detach()
    for i in range(0, X_rows.shape[0], row_block):
        gl, g_rows[i:i + row_block], gc = block_quad_grads(
            kernel, params, leaves, X_rows[i:i + row_block], X_cols,
            A[i:i + row_block].detach(), V)
        g_acc = [a + b for a, b in zip(g_acc, gl)]
        g_cols += gc
    return params_unflatten(params, g_acc), g_rows, g_cols
