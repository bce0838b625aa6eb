"""Dense-slab oracles for the fused kernel-MVM.

Materializes the whole (m, n) slab — O(m n) memory — exactly what the
fused kernel avoids. Tests hold the kernels and their plain versions
against these.
"""

from __future__ import annotations

import torch

from repro_torch.core.kernels_math import kernel_from_sqdist, kernel_matrix, sq_dist


def kmvm_ref(kernel, Xi: torch.Tensor, Xj: torch.Tensor, V: torch.Tensor,
             params) -> torch.Tensor:
    """K(Xi, Xj) @ V with the dense slab, full hyperparameters applied."""
    K = kernel_matrix(kernel, Xi, Xj, params)
    return (K @ V.to(K.dtype)).to(torch.float32)


def kmvm_prescaled_ref(kind: str, Xi: torch.Tensor, Xj: torch.Tensor,
                       V: torch.Tensor) -> torch.Tensor:
    """Unit-hyperparameter oracle matching one fused-kernel component
    (inputs pre-scaled by lengthscale, V pre-scaled by the base weight)."""
    d2 = sq_dist(Xi.to(torch.float32), Xj.to(torch.float32))
    return kernel_from_sqdist(kind, d2) @ V.to(torch.float32)
