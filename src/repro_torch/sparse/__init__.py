"""repro_torch.sparse — compactly-supported kernels with distance-pruned MVMs.

The counterpart of `repro.sparse`. Layering:

    plan         Morton reordering, per-tile bounding boxes, the static
                 block mask + active-pair list, drift-triggered replanning
                 (plans and digests identical to the reference's)
    kmvm_sparse  the block-sparse CUDA kernel (B4) and its plain version
    blocksparse  the "blocksparse" KernelOperator backend, and its
                 distributed composition (`dist_blocksparse_kmvm`,
                 `validate_dist_plan`; `plan.chunk_sliced_plan`)

    from repro_torch.sparse import build_plan
    plan = build_plan("matern32 * wendland2", X, params, tile=256)
"""

from .plan import (
    ChunkSlicedPlan,
    SparsePlan,
    build_plan,
    chunk_sliced_plan,
    morton_order,
    needs_replan,
    plan_is_safe,
    spec_support_radius,
)
from .blocksparse import (
    BlockSparseOperator,
    dist_blocksparse_kmvm,
    masked_kmvm,
    sparse_quad_form_partials,
    validate_dist_plan,
)

__all__ = [
    "BlockSparseOperator",
    "ChunkSlicedPlan",
    "SparsePlan",
    "build_plan",
    "chunk_sliced_plan",
    "dist_blocksparse_kmvm",
    "masked_kmvm",
    "morton_order",
    "needs_replan",
    "plan_is_safe",
    "sparse_quad_form_partials",
    "spec_support_radius",
    "validate_dist_plan",
]
