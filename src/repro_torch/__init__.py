"""repro_torch — exact-GP training and serving in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A second package beside the JAX reference `repro`, with the same module
layout (`repro/core/pcg.py` <-> `repro_torch/core/pcg.py`) and the same
public names. It imports `torch` only: nothing of JAX and nothing of
`repro`. Layering (bottom-up):

    device             resolve `device=None` to the card; force IEEE fp32
                       matmuls (TF32 off) at import
    core.kernels_math  kernel algebra (KernelSpec trees + KernelParams
                       NamedTuples of tensors, expression parser)
    kernels.kmvm       the three dense CUDA kernels (fused kernel-MVM, the
                       same plus the CG dot block, and its chunk-accumulate
                       step) with their plain versions
    kernels.ops        spec -> fused-pass plan, dtype policy, block_fn
    kernels.autotune   the column split of the fused kernels, swept once per
                       card, dtype, spec and shape bucket, cached on disk
    core.partitioned   row-blocked K @ V and its autograd backward
    core.operators     KernelOperator registry: dense / partitioned / pallas
                       (+ blocksparse and sharded, registered lazily)
    sparse             Morton plan + block mask (same digests as the
                       reference), the block-sparse CUDA kernel, the
                       blocksparse backend
    core.pivchol       pivoted-Cholesky preconditioner (+ probe sampling)
    core.pcg           batched PCG (standard / pipelined / fused step)
    core.slq, core.mll SLQ log-determinant; the BBMM MLL and its Eq. 2
                       backward (`exact_mll`, a torch.autograd.Function)
    core.gp            ExactGP
    core.distributed   the sharded engine on a torch.distributed mesh
                       (ShardedOperator, 1-D / 2-D layouts, the ring
                       contraction on the chunk-accumulate CUDA kernel, the
                       distributed MLL, warm steps and mean-cache solve)
    core.predcache     mean cache + Lanczos variance cache, predictions
    core.sgpr, svgp    the paper's approximate-GP baselines (Table 1)
    optim              Adam, L-BFGS, LR schedules
    train              warm-started solve engines (one device, sharded),
                       `fit_exact_gp`, `fit_sgpr` / `fit_svgp`, checkpoints
                       and `CheckpointManager`
    serve              PosteriorArtifact, PredictionEngine, MicroBatcher
    launch.mesh        process-group meshes, `init_distributed`
    launch.serve_gp    fit-or-load a posterior and serve requests
    launch.train       train the exact GP on the distributed engine

Every entry point puts its tensors on `cuda` unless the caller passes
`device="cpu"`; with no card and no explicit device it raises.
"""

from . import device  # noqa: F401  (sets the TF32 switches)
