"""Modeled kernel-launch and HBM-traffic accounting per MLL solver step.

The counterpart of `repro.obs.costmodel`, with the same arithmetic, so the
metrics registry and the phase spans can carry "how many kernel launches
and how many modeled HBM bytes did this solve cost":

* dense / partitioned slab path: the (rb, n) slab is written to device
  memory once and read back once by the GEMM — 2 * itemsize bytes per
  kernel-matrix entry per traversal; one launch per row slab.
* pallas (the fused Hopper kernels B1/B2): the slab never reaches device
  memory; traffic per entry is the Xj/V tile streaming amortized over the
  bm output rows — itemsize * (d + r) / bm bytes per entry — and the whole
  (n, n) grid is ONE launch. bm defaults to 64, the row tile of the port's
  B1-B3 (`repro_torch.kernels.kmvm.ROW_TILE`).
* blocksparse: the partitioned accounting scaled by the plan's fill ratio
  (work and traffic are pair-proportional by construction).

The port's PCG loop stops once every column has converged (checked every
8 iterations, `core/pcg.py`), so its engines charge the MVMs the loop
ran (`PCGResult.loop_mvms`) as `max_cg_iters`, plus one warm-init MVM when
x0 is seeded. The Eq. 2 backward adds ~2.5 slab-equivalent traversals
over the merged (t+1)-column quad-form chain.

These are MODELED numbers — a consistent cost ruler across steps and
backends, not measured hardware counters. `obs_report` labels them so.
"""

from __future__ import annotations

import math
from typing import NamedTuple

# the fused kernels' row tile (repro_torch.kernels.kmvm.ROW_TILE; not
# imported: obs stays free of the kernels package)
_DEFAULT_BM = 64

# the merged backward is one quad-form chain of ~2-3 slab passes (slab +
# autograd residuals); charge the midpoint
BACKWARD_TRAVERSALS = 2.5


class StepCost(NamedTuple):
    launches: int          # device kernel launches for the step's MVMs
    hbm_bytes: float       # modeled HBM traffic of those traversals
    traversals: float      # kernel-matrix traversals charged


def mll_step_cost(
    n: int,
    d: int,
    num_rhs: int,
    max_cg_iters: int,
    *,
    backend: str = "partitioned",
    row_block: int = 1024,
    bm: int | None = None,
    dtype_bytes: int = 4,
    fill: float = 1.0,
    warm_init: bool = False,
    include_backward: bool = True,
) -> StepCost:
    """Modeled launches + HBM bytes for ONE MLL solver step.

    num_rhs: mBCG matmat width r = 1 + num_probes (y rides with the SLQ
    probes). max_cg_iters: the CG loop iterations charged as traversals (the
    port's engines pass the MVMs the loop ran, `PCGResult.loop_mvms`).
    warm_init: x0 was seeded, adding the r0 = B - K x0 MVM. fill:
    blocksparse active fraction (1.0 = dense mask). bm: the fused kernel's
    row tile (None = B1-B3's 64).
    """
    if bm is None:
        bm = _DEFAULT_BM
    fwd_traversals = max_cg_iters + (1 if warm_init else 0)
    traversals = float(fwd_traversals)
    if include_backward:
        traversals += BACKWARD_TRAVERSALS

    entries = float(n) * float(n)
    if backend in ("dense",):
        bytes_per_entry = 2.0 * dtype_bytes
        launches_per_traversal = 1
    elif backend == "pallas":
        bytes_per_entry = dtype_bytes * (d + num_rhs) / max(bm, 1)
        launches_per_traversal = 1
    elif backend == "blocksparse":
        entries *= max(min(fill, 1.0), 0.0)
        bytes_per_entry = 2.0 * dtype_bytes
        # one B4 launch over the plan's active pairs per traversal
        launches_per_traversal = 1
    else:  # partitioned and sharded-partitioned slabs
        bytes_per_entry = 2.0 * dtype_bytes
        launches_per_traversal = max(1, math.ceil(n / max(row_block, 1)))

    # the backward contracts through the partitioned (or blocksparse)
    # gradient surface at full precision: slab traffic, 2 * itemsize per
    # entry, on every backend (pallas included)
    fwd_bytes = entries * bytes_per_entry * fwd_traversals
    bwd_bytes = 0.0
    bwd_launches = 0
    if include_backward:
        slab_bytes_per_entry = 2.0 * dtype_bytes
        bwd_bytes = entries * slab_bytes_per_entry * BACKWARD_TRAVERSALS
        bwd_launches = max(1, math.ceil(n / max(row_block, 1)))

    launches = fwd_traversals * launches_per_traversal + bwd_launches
    return StepCost(launches=int(launches),
                    hbm_bytes=fwd_bytes + bwd_bytes,
                    traversals=traversals)


def mll_phase_costs(
    n: int,
    d: int,
    num_rhs: int,
    max_cg_iters: int,
    *,
    backend: str = "partitioned",
    row_block: int = 1024,
    bm: int | None = None,
    dtype_bytes: int = 4,
    fill: float = 1.0,
    warm_init: bool = False,
    precond_rank: int = 0,
) -> dict:
    """Split `mll_step_cost` into the four separately fenced phases of the
    engine's phased dispatch, so each measured phase span can carry its own
    modeled bytes (`obs_report --compare-model` joins on the phase name).

    * precond_build: rank-k partial pivoted Cholesky materializes one
      kernel row slab per pivot — n * rank entries, slab traffic.
    * cg_solve: the mBCG forward traversals (warm-init MVM included).
    * slq_logdet: reuses the mBCG tridiagonal coefficients — small (t, t)
      eigensolves, no kernel-matrix traffic; charged one launch.
    * eq2_backward: the merged quad-form chain (BACKWARD_TRAVERSALS).
    """
    fwd = mll_step_cost(n, d, num_rhs, max_cg_iters, backend=backend,
                        row_block=row_block, bm=bm, dtype_bytes=dtype_bytes,
                        fill=fill, warm_init=warm_init,
                        include_backward=False)
    full = mll_step_cost(n, d, num_rhs, max_cg_iters, backend=backend,
                         row_block=row_block, bm=bm, dtype_bytes=dtype_bytes,
                         fill=fill, warm_init=warm_init,
                         include_backward=True)
    bwd = StepCost(launches=full.launches - fwd.launches,
                   hbm_bytes=full.hbm_bytes - fwd.hbm_bytes,
                   traversals=full.traversals - fwd.traversals)
    pc_entries = float(n) * float(max(precond_rank, 0))
    if backend == "blocksparse":
        pc_entries *= max(min(fill, 1.0), 0.0)
    precond = StepCost(launches=max(precond_rank, 0),
                       hbm_bytes=pc_entries * 2.0 * dtype_bytes,
                       traversals=0.0)
    slq = StepCost(launches=1, hbm_bytes=0.0, traversals=0.0)
    return {"precond_build": precond, "cg_solve": fwd,
            "slq_logdet": slq, "eq2_backward": bwd}


class CollectiveCost(NamedTuple):
    gather_bytes: float    # per-rank per-MVM V-chunk transfer volume
    scatter_bytes: float   # per-rank per-MVM reduce-scatter volume
    exposed_bytes: float   # the part NOT hidden behind tile compute


def dist_collective_cost(
    n: int,
    num_rhs: int,
    *,
    d_row: int = 1,
    d_col: int = 1,
    overlap: bool = False,
    dtype_bytes: int = 4,
) -> CollectiveCost:
    """Modeled per-rank collective volume of ONE distributed MVM.

    The 2-D scheme (`core.distributed.dist_kmvm`): each rank gathers the
    d_row - 1 remote V chunks of its column group (n_local * r bytes each,
    n_local = n / (d_row * d_col)) and scatters its row partial over the
    col axes (d_col - 1 remote chunks). 1-D is the d_col = 1 special case
    — the paper's O(n) gather.

    overlap=True models the collective-matmul pipeline: chunk transfers
    ride the ring DURING tile compute, so only the FIRST hop (the pipeline
    fill, one chunk) plus the trailing scatter stay exposed; serial mode
    exposes everything. Total volume is identical either way — overlap
    buys exposure, not bytes.
    """
    n_local = n / float(max(d_row * d_col, 1))
    chunk = n_local * num_rhs * dtype_bytes
    gather = (d_row - 1) * chunk
    scatter = (d_col - 1) * chunk
    exposed = (chunk * min(d_row - 1, 1) + scatter) if overlap \
        else (gather + scatter)
    return CollectiveCost(gather_bytes=gather, scatter_bytes=scatter,
                          exposed_bytes=exposed)
