"""gp-exact-1m: the paper's own workload as a first-class dry-run arch.

Exact-GP BBMM training step at n = 2^20 (HouseElectric scale, d = 9) on the
production mesh: distributed pivoted-Cholesky preconditioner + 20 fixed PCG
iterations (the paper's eps=1 training regime converges in <= ~20) + the
Eq. 2 hyperparameter gradient. See repro_torch.core.distributed.
"""
from typing import NamedTuple


class GPWorkloadConfig(NamedTuple):
    name: str = "gp-exact-1m"
    family: str = "gp"
    n: int = 1 << 20
    d: int = 9
    # a stationary kind (the paper's Matern-3/2) or a composable spec
    # expression such as "0.5*rbf + matern32" — parsed by
    # repro_torch.core.kernels_math.parse_kernel and threaded through every
    # backend (the fused `pallas` path fuses same-pass components; see
    # repro_torch.kernels.ops.mvm_plan)
    kernel: str = "matern32"
    precond_rank: int = 100
    num_probes: int = 8
    train_cg_iters: int = 20
    pred_cg_iters: int = 100
    mode: str = "2d"           # "1d" = paper-faithful, "2d" = beyond-paper
    row_block: int = 1024
    # KernelOperator knobs: inner slab backend per device tile and the
    # compute dtype ("bfloat16" = bf16 operands, fp32 accumulation)
    backend: str = "partitioned"
    compute_dtype: str | None = None
    # ring-pipeline the per-iteration gather against the tile compute
    # (collective-matmul chunking; repro_torch.core.distributed overlap path)
    overlap: bool = False


CONFIG = GPWorkloadConfig()
