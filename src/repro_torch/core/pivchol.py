"""Partial pivoted Cholesky preconditioner (paper Section 3, "Preconditioning").

A rank-k pivoted Cholesky factor L (n, k) of the noise-free kernel K gives
P = L L^T + sigma^2 I, applied through the Woodbury identity; its
log-determinant follows from the matrix determinant lemma, and P admits
exact sampling (z = L e1 + sigma e2), which the SLQ probes need. Computing
L touches k kernel rows: O(n k) memory, O(n k^2 + n d k) time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .kernels_math import kernel_diag, kernel_matrix, noise_variance


def pivoted_cholesky(kernel, X: torch.Tensor, params, rank: int) -> torch.Tensor:
    """Rank-`rank` pivoted Cholesky factor of K_XX (noise-free): L (n, rank)
    with K ~= L L^T, greedily minimizing the trace of the residual.

    The loop stays on the device: the pivot is a 0-d index tensor, never
    brought to the host. State is at least fp32.
    """
    n = X.shape[0]
    d0 = kernel_diag(kernel, X, params)
    diag = d0.to(torch.promote_types(d0.dtype, torch.float32)).clone()
    L = torch.zeros((rank, n), dtype=diag.dtype, device=X.device)
    for i in range(rank):
        p = torch.argmax(diag).reshape(1)
        row = kernel_matrix(kernel, X.index_select(0, p), X, params)[0]
        # rows >= i of L are zero, so the full contraction is exact
        row = row - L.index_select(1, p)[:, 0] @ L
        pivot = torch.clamp(diag.index_select(0, p), min=1e-12)
        li = row / torch.sqrt(pivot)
        li.index_copy_(0, p, torch.sqrt(pivot).to(li.dtype))
        L[i] = li
        diag = torch.clamp(diag - li * li, min=0.0)
        diag.index_fill_(0, p, -float("inf"))  # never re-pick a pivot
    return L.T


class Preconditioner(NamedTuple):
    """P = L L^T + sigma^2 I, with the cached k x k lower Cholesky factor of
    (sigma^2 I + L^T L)."""

    L: torch.Tensor           # (n, k)
    sigma2: torch.Tensor      # ()
    chol_inner: torch.Tensor  # (k, k)

    @property
    def rank(self) -> int:
        return self.L.shape[1]

    def solve(self, V: torch.Tensor) -> torch.Tensor:
        """P^{-1} V via Woodbury: sigma^-2 (V - L (s2 I + L^T L)^{-1} L^T V)."""
        LtV = self.L.T @ V
        inner = torch.cholesky_solve(LtV, self.chol_inner, upper=False)
        return (V - self.L @ inner) / self.sigma2

    def logdet(self) -> torch.Tensor:
        """log det P via the matrix determinant lemma."""
        n, k = self.L.shape
        logdet_inner = 2.0 * torch.sum(torch.log(torch.diagonal(self.chol_inner)))
        return (n - k) * torch.log(self.sigma2) + logdet_inner

    def sample(self, generator: torch.Generator | None, num: int,
               dtype=None) -> torch.Tensor:
        """(n, num) probes z ~ N(0, P), exactly: z = L e1 + sigma e2, with
        e1 (k, num) and e2 (n, num) standard normal draws from `generator`
        (on the factor's device). The reference draws the same distribution
        from a jax key; the streams differ."""
        dtype = dtype or self.L.dtype
        n, k = self.L.shape
        dev = self.L.device
        e1 = torch.randn((k, num), generator=generator, dtype=dtype, device=dev)
        e2 = torch.randn((n, num), generator=generator, dtype=dtype, device=dev)
        return self.L.to(dtype) @ e1 + torch.sqrt(self.sigma2).to(dtype) * e2


def make_preconditioner(
    kernel,
    X: torch.Tensor,
    params,
    rank: int,
    noise_floor: float = 1e-4,
    jitter: float = 1e-6,
    reuse: Preconditioner | None = None,
) -> Preconditioner:
    """The rank-k pivoted-Cholesky preconditioner for K_hat.

    reuse: return a previous Preconditioner as-is instead of refactorizing
    (CG stays exact under any fixed SPD preconditioner).
    """
    if reuse is not None:
        if reuse.rank != (rank if rank > 0 else 0):
            raise ValueError(
                f"cannot reuse a rank-{reuse.rank} preconditioner for "
                f"rank={rank}")
        return reuse
    s2 = noise_variance(params, noise_floor)
    if rank <= 0:  # identity-preconditioner degenerate case: L = (n, 0)
        n = X.shape[0]
        L = torch.zeros((n, 0), dtype=X.dtype, device=X.device)
        chol = torch.zeros((0, 0), dtype=X.dtype, device=X.device)
        return Preconditioner(L=L, sigma2=s2, chol_inner=chol)
    L = pivoted_cholesky(kernel, X, params, rank)
    eye = torch.eye(rank, dtype=L.dtype, device=L.device)
    inner = s2 * eye + L.T @ L + jitter * eye
    return Preconditioner(L=L, sigma2=s2, chol_inner=torch.linalg.cholesky(inner))


def extend_preconditioner(precond: Preconditioner, m: int) -> Preconditioner:
    """P extended to m appended rows by zero-padding the factor:
    P_ext = [[P, 0], [0, sigma^2 I_m]].

    Zero rows leave L^T L, and so `chol_inner`, exactly unchanged: the
    Woodbury solve, the logdet (which reads n from L) and sampling stay
    consistent without refactorizing. P_ext is SPD, so CG under it stays
    exact; the new rows see plain sigma^2 until the next full rebuild. The
    streaming update's analogue of `reuse=` (O(m k) per batch).
    """
    if m < 0:
        raise ValueError(f"cannot extend a preconditioner by {m} rows")
    if m == 0:
        return precond
    pad = torch.zeros((m, precond.L.shape[1]), dtype=precond.L.dtype,
                      device=precond.L.device)
    return precond._replace(L=torch.cat([precond.L, pad], dim=0))
