"""repro_torch.sparse — compactly-supported kernels with distance-pruned MVMs.

The counterpart of `repro.sparse` on one device. Layering:

    plan         Morton reordering, per-tile bounding boxes, the static
                 block mask + active-pair list, drift-triggered replanning
                 (plans and digests identical to the reference's)
    kmvm_sparse  the block-sparse CUDA kernel (B4) and its plain version
    blocksparse  the "blocksparse" KernelOperator backend

The reference's distributed composition (`dist_blocksparse_kmvm`,
`validate_dist_plan`, `chunk_sliced_plan`) belongs to the distributed slice
and is not ported yet.

    from repro_torch.sparse import build_plan
    plan = build_plan("matern32 * wendland2", X, params, tile=256)
"""

from .plan import (
    SparsePlan,
    build_plan,
    morton_order,
    needs_replan,
    plan_is_safe,
    spec_support_radius,
)
from .blocksparse import (
    BlockSparseOperator,
    masked_kmvm,
    sparse_quad_form_partials,
)

__all__ = [
    "BlockSparseOperator",
    "SparsePlan",
    "build_plan",
    "masked_kmvm",
    "morton_order",
    "needs_replan",
    "plan_is_safe",
    "sparse_quad_form_partials",
    "spec_support_radius",
]
