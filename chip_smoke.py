"""Drive the PyTorch/CUDA port's paths on one NVIDIA GPU.

    python3 chip_smoke.py

Every phase runs, in this order (any failure exits non-zero; nothing is
caught and skipped):

1. Device: name, count, torch/CUDA versions, nvidia-smi name and power limit.
2. Build: compile the CUDA kernels from `src/repro_torch/kernels/csrc/`
   with nvcc (sm_90a); print the build seconds, then for each fp32
   instance at t-chunks 1 and 16 its ptxas registers, stack and spill and
   its SASS counts (`cuobjdump -sass`: LDL/STL, MUFU, barriers, HMMA
   tensor-core instructions, and the instructions, local-memory and shared
   loads and stores of the entry loop and the chunk loop).
3. Kernels against their plain PyTorch versions on the card: B1
   (`kmvm_fused`) and B2 (`kmvm_fused_dots`) on fp32 and bf16, five kernel
   kinds, ragged m and n, d in {9, 385}, t in {1, 7, 128}, and the main-path
   shape (the first 2048 training rows against all n). Tolerance: 2e-4
   (fp32) and 5e-2 (bf16) relative to max|out|, as the reference's kernel
   tests use — only the summation order differs. Then each kernel is timed
   with CUDA events at the main-path shapes beside its plain version and
   its bounds: B1 and B2 at (2^16, 2^16, 9, 1) (serving) and (2^17, 2^17,
   9, 1) (the distributed path's single-card Lanczos and CG steps), B1 at
   a 1024-row prediction chunk (t = 128), each beside `bound_ms` and
   `tc_bound_ms` (below). Last, the per-entry cost table: B1 at (2^16,
   2^16, t = 1) for d in {2, 9} and the specs rbf, matern32 and matern32 *
   wendland2, plus matern32 at d = 9, t = 9, then B2 and B3 at d = 9,
   matern32, t = 1 and 9, in ps per kernel entry (the differences give the
   cost of one feature, of one epilogue factor, of K @ V and of B2's and
   B3's schedules beside B1's).
   Then B5 (`kgrad_fused`, the Eq. 2 backward's kernel) at (2^16, 2^16,
   d 9, 9 column pairs) on he-train's matern32 hyperparameters: against
   its plain version in fp64 (1e-4 of each output), timed beside that
   plain version in fp32, the autograd loop it replaces at 512-row blocks
   and `kgrad_grads` (the kernel and the host's chain rule). Its launches
   per training step are read in phase 4c's traced step.
4. Serve: the port's `serve_gp` launcher in-process, twice, on the
   houseelectric analogue (d = 9) at n = 2^16, matern32 on the `pallas`
   backend in fp32. The first run trains the hyperparameters with
   `fit_exact_gp` as the reference's launcher does (L-BFGS and Adam on a
   512-point subset, two full-data steps) and prints them, runs
   `fit_posterior` (precond rank 100, Lanczos rank 128, tol 0.01, <= 400 CG
   iterations), saves and loads the artifact, verifies a chunk-1024 engine
   against the unchunked result (<= 1e-5) and sends 200 requests x 8 points
   from 8 clients through the MicroBatcher. Then `PredictionEngine.from_dir`
   on the saved artifact (chunk 1024): its `predict_mean` on 8192 of the
   draw's test rows must equal `predict(...)[0]` of an engine built on
   `load_artifact` bit for bit, with B1 launched (counts set to 0 just
   before, read just after); its backend, kernel and fused passes
   (`mvm_plan(...).num_fused_passes`) are printed. The second run loads that
   artifact (no second training) and serves the same traffic through the
   ServeFleet (`--scheduler continuous --models 2 --workers 2`; model m1
   refits the caches on n - 256 rows), then absorbs 64 rows into m0
   (`--observe 64`) and refits cold on the same extended data. Gates: the
   fit's residual <= 0.01, verify <= 1e-5; B1 and B2 launched in each run
   (counts set to 0 just before, read just after) and B2 during the
   update; the update's residual <= its artifact's tolerance; fewer warm
   CG iterations than the cold refit's; the fleet's predictions for 64
   pool rows equal a direct engine call's (means bit for bit, variances
   within 1e-5 of max|var|); the updated mean within 3e-2 of max|mean| of
   the cold refit's on 512 queries (two solves stopped at 0.01); updated
   variances finite and > 0. Printed: the trained hyperparameters and
   loss, CG steps, the update and refit seconds and their ratio, per-model
   p50/p99/QPS, batches, requests per launch, padded rows, and how long a
   request to m1 waited behind the update. n stays cut from the
   configuration's 2^20 to 2^16 (PERF.md).
4a. Autotune (`repro_torch.kernels.autotune`) at the exact GP's shapes,
   on phase 4's trained artifact: a sweep of the column split
   (`tiles_per_split` 16, 32, 64, 128, 256 and the whole range) of B1 + B2
   at (2^16, 2^16, d 9) for t = 1 and t = 9, matern32, fp32, into a fresh
   cache under build/, each candidate's time printed beside the choice;
   a second call hits the memo and, after `clear_memo`, a third the disk
   (counters: 1 sweep, then 2 hits). B1 and B2 at every candidate against
   their plain versions on the first 2048 rows against all 2^16 (2e-4 of
   max|out|); at the tuned split a row's B1/B2 result is the same bit for
   bit in a 64-row, a 2048-row and the full launch, and B2's out equals
   B1's; B1 and B2 timed at the default and the tuned split in turns. Then
   `fit_posterior` on an `autotune=True` operator: residual <= 0.01, B1 and
   B2 launched at the tuned split, the mean on 512 test points within 3e-2
   of max|mean| of the phase-4 artifact's (the default split; two solves
   stopped at 0.01).
4b. Table 1 (the paper's comparison) on phase 4's draw of the
   houseelectric analogue (n = 2^16 training rows, 49152 test rows), fp32:
   the exact GP (phase 4's trained artifact through the engine), SGPR
   (m = 512, 100 steps of Adam(0.1)) and SVGP (m = 1024, batch 1024,
   Adam(0.01), 100 epochs), the paper's widths; each method's test RMSE
   and NLL, training seconds, seconds per step or epoch and peak memory;
   then `examples/quickstart_torch.py`'s `main()` on the card, its rows
   printed. Gates: every loss, RMSE and NLL finite; SGPR's last loss below
   its first, SVGP's last epoch's below its first; on four 4096-row
   subsets `sgpr_loss` and `svgp_loss` on the card equal their CPU values
   from the same trained params within 1e-4 relative, evaluated in fp64
   (the fp32 values of both devices are printed beside it with their
   distance from the fp64 value: the trained SVGP loss is small, about
   0.06, and in fp32 each device's value lies 1e-4..1e-3 of itself from
   the fp64 one, with the order of the sums; PERF.md). Whether the exact
   GP's RMSE beats both baselines is printed, not gated.
4c. Tracing (`repro_torch.obs`) on phase 4's training: `fit_exact_gp`
   exactly as the serve launcher runs it (matern32 on `pallas`, fp32,
   L-BFGS and Adam on a 512-point subset, two full-data steps) on phase
   4's draw at n = 2^16, d = 9, untraced and then under
   `obs.trace_session` with the health sink and profiling on, from the same
   seed and initial parameters. The trace goes through `obs_report`'s
   `main()` with `--compare-model --hbm-gbps 3350 --health`; printed: per
   phase the measured ms, the modeled bytes, the modeled ms at 3350 GB/s
   and their ratio, each phase's share of the full-data training steps,
   and the traced fit's seconds beside the untraced one's; the phase
   table's self-times against the fit's wall are printed (they add up by
   construction). Then one traced cold `WarmStartEngine.step` at the
   trained parameters, launch counts set to 0 just before it and read just
   after. Gates: the same telemetry modes; loss traces equal bit for bit
   (else within 1e-6 relative); the spans fit_exact_gp, optimizer_step,
   mll_step, precond_build, cg_solve, slq_logdet and eq2_backward; the
   four phase spans within 1% of the mll_step spans that hold them (work
   escaping a phase's fence would land outside them); the cold step's B1 +
   B2 launches equal its cg_solve span's modeled launches; a memory
   snapshot with cuda0's bytes in use > 0; no health event of severity
   error.
5. Block-sparse kernel B4 (`kmvm_blocksparse`) against its plain version
   (same tolerances): plan tiles 8, 32, 64 and 256 on ragged n, t in
   {1, 9, 128}, fp32 and bf16, specs `matern32 * wendland2`, `wendland4`,
   `rbf * wendland2 + matern32 * wendland4` and the non-compact `matern32`
   on its all-active plan, where B4 must also equal B1 within the same
   tolerance; each case launched longest row first (the plan's order) must
   equal the launch in plan order bit for bit. Then B4 is timed at the
   spatial path's shape (n = 2^18, tile 256, t = 1 and t = 9, the plan's
   launch order) beside its plain version and its two bounds.
6. Spatial (the `examples/spatial_gp.py` configuration): the clustered 2-D
   field (32 stations, sigma 0.03, dataset seed 0) at n = 2^18 training
   points, `matern32 * wendland2` from noise 0.3 and radius 0.15 on the
   `blocksparse` backend in fp32 (plan tile 256). `fit_exact_gp(method=
   "adam")` takes SPATIAL_STEPS full-data steps (precond rank 50, train CG
   <= 50, warm-start engine, drift replans); `fit_posterior` at the trained
   hyperparameters (rank 50, Lanczos rank 100, residual <= 0.01 within 400
   iterations); the artifact is saved and loaded (plan digest verified);
   the Morton-sorting engine (chunk 1024) is checked against the unchunked
   result (<= 1e-5); 200 requests x 8 points from 8 clients go through the
   MicroBatcher. B4's launch counter is set to 0 just before and read just
   after; it must be > 0. Then `PredictionEngine.from_dir` on the saved
   artifact, as in phase 4: its `predict_mean` on the test points equals
   the first engine's means bit for bit, with B4 launched (counts set to 0
   just before, read just after). Then the engine's cross-covariance launch for
   one Morton-sorted 1024-query chunk (64-row query tiles against the
   256-row plan tiles, query rows repeated per column segment, t = 1 for
   the mean and t = 100 for the variance) is held against B4's plain
   version on the same operands (2e-4 relative to max|out|) and timed,
   beside its plain version and its bounds (1024 queries against the
   active tiles' columns). Last, the artifact is registered in a one-model
   ServeFleet and absorbs 64 new field points (the next seed's draw; B4's
   count set to 0 just before the update and read just after): B4
   launched during the update, its residual <= the artifact's tolerance,
   its mean on 512 test points within 5e-2 of max|mean| of a cold
   `fit_posterior` on the rebuilt plan and of a solve of the extended
   system to 1e-4, variances finite and > 0; both times, the CG
   iterations and the plan's pairs before and after are printed. The 5e-2
   is the reference's own bound between an observed posterior and a cold
   refit (`tests/test_serve_fleet.py::test_fleet_observe_updates_posterior`):
   on this system a solve stopped at 0.01 lies up to 3.2e-2 from the
   tight one (PERF.md), so the 3e-2 of phase 4 does not bound two such
   solves here. n is cut from the paper's 2^20 (PERF.md).
7. Cross-check: the MLL value and Eq. 2 gradients on `blocksparse` (B4)
   against the `partitioned` backend on the card at n = 2^13, with the
   same injected probes and preconditioner, within the conformance
   tolerances (value 3e-5 relative; hyperparameter gradients rtol 5e-3,
   atol 5e-4; the X gradient, whose entries are sums of large cancelling
   terms at this n, within 5e-3 of its largest entry).
8. Chunk-accumulate kernel B3 (`kmvm_fused_chunk`) against its plain
   version (2e-4 / 5e-2 of max|out|): ragged m, column chunks of 64 to
   4096, t in {1, 9, 128}, fp32 and bf16, two specs; and a walk over
   chunks of whole 64-column tiles against one B1 launch over the same
   n = 4096 columns, bit for bit at t = 9 and t = 128 and for a single
   chunk at t = 1 (at t = 1 the final 16-thread tree of each row regroups a
   multi-chunk walk's sum, held to the tolerance instead). Then B3 is timed
   at the shape of one ring step of eight cards at n = 2^20 (rows = chunk =
   2^17, d = 9, t = 1 and t = 9) beside its plain version and its two bounds.
9. Distributed (the paper's Section 3 engine, `repro_torch.core.
   distributed`) as a one-rank NCCL group (a `file://` store in a temporary
   directory; no network): `repro_torch.launch.train`'s gp-exact-1m path
   in-process with `--gp-n 98304` (n = 2^17 of the houseelectric analogue,
   d = 9: the per-card shard of the paper's 1M-point run on eight cards),
   `--gp-backend pallas --gp-mode 2d --gp-overlap --steps 3`, fp32, and
   `--save-artifact` (the single-device `fit_posterior` route); then
   `make_mean_cache_solve` (tol 0.01, <= 400 iterations) and
   `posterior_from_mean_cache`, saved, loaded and served through the
   engine (checked against the unchunked result, <= 1e-5). The two routes'
   test RMSE must agree within 2%; one MVM with overlap on and off must be
   bit for bit equal; B3's launch counter, set to 0 just before the phase,
   must be > 0 after it. The launcher runs with `--obs-trace`: its trace
   must hold one `mll_step` span per step and goes through `obs_report`;
   `obs.measure.collective_microbench` on the one-rank group must return
   [] (one rank has nothing to transfer). Step seconds, CG iterations, the
   solve's residual and iterations and peak memory are printed.
10. Distributed blocksparse cross-check: the MLL value and Eq. 2
   gradients of `ShardedOperator(inner_backend="blocksparse")` (B4 per
   ring chunk) against the single-device blocksparse MLL on the spatial
   field at n = 2^13, same injected probes and preconditioner, within the
   conformance tolerances (as phase 7).
11. Deep kernel learning (`repro_torch.core.dkl` over `repro_torch.models`):
   smollm-360m at its published width (32 layers, d 960, 15 heads on 5 KV
   heads, ff 2560, vocab 49152; fp32 weights from a seeded generator) under
   an exact-GP head, matern32 on the `pallas` backend (precond rank 20, <= 30
   training CG iterations, from noise 0.2 and the initial features' median
   pairwise distance as the lengthscale, so K is far from the identity). Data: 2048 training and 1024
   held-out sequences of 64 seeded random tokens, the reference example's
   target sin(mean(tokens[:, ::4]) / 8) + 0.05 noise. Three Adam steps
   (lr 3e-3) over the backbone and the GP's hyperparameters, each on
   `DKLModel.loss` (the backward through the MLL's Eq. 2 gradient with
   respect to the pooled features, then through the backbone with
   per-block checkpointing); then `precompute` and `predict` on the
   held-out sequences. B1 and B2's counts are set to 0 just before and read
   just after. Printed: the step seconds and loss trace, the launches, peak
   memory, the embedding's largest move and step 0's largest gradient of
   it, train and test RMSE. Gates: every loss finite; B1 and B2 launched;
   the embedding moved by at least lr / 2 (the gradient through the MLL's
   g_X cleared Adam's eps); predictions finite, variances > 0; the pooled
   features of 4 held-out sequences on the card within 2e-4 of max|f| of
   the same backbone's on the CPU; at the trained features (2048 x 2048,
   d 960, t 1 and 9; operands as the `pallas` operator passes them) the
   off-diagonal part of K @ V at least 10x the tolerance, and B1 and B2
   within 2e-4 of max|out| of their plain versions, then timed beside them
   and their bounds. Printed, not gated: B1 and the plain version against
   an fp64 evaluation, and the same at the default lengthscale, where K is
   the identity (ROADMAP C3).
12. Serving the LMs (`repro_torch.launch.serve`'s `main`, in-process,
   `--full`, fp32 weights from a seeded generator) for six families at
   their published width and depth, one model on the card at a time:
   smollm-360m (batch 4, prompt 256), qwen2-moe-a2.7b (4 x 256),
   mamba2-130m (4 x 1000, not a multiple of its 256-token chunk),
   hymba-1.5b (2 x 1536, past its 1024-token window), seamless-m4t-large-v2
   (4 x 256 tokens on 256 encoder frames) and qwen2-vl-7b (4 x 256, patch
   embeddings on the first 64 positions); prefill, then 31 greedy decode
   steps. Printed per arch: parameters, prefill ms, decode tokens per
   second and the decode steps' ms (first, median), peak memory, the
   card's name and power limit; for MoE the (token, k) pairs the prefill
   drops at capacity factor 1.25. Gates: (a) every logit finite; (b) decode
   steps 1-4 within 2e-3 of max|logit| of the full forward at the same
   positions over the same tokens (the reference's own check,
   `tests/test_models_smoke.py:81`), per sequence. For MoE the top-k
   choice is discontinuous, and a token at a near-tie may route
   differently in the two runs: at its own top-k with capacity factor
   E / k (nothing drops, gated) the sequences that routed alike must
   agree and any that did not must have first differed at a margin below
   1e-4, and with every expert active (top-k = E, routing continuous)
   every sequence must agree; (c) the position after decoding is prompt +
   31; (d) at the published width but depth 2, `forward_hidden` on 2 x 32
   tokens on the card within 2e-4 of max|h| of the CPU's, same weights.
   B1-B4's launches over the phase are printed (none on this path).
13. The dry run's counter (`repro_torch.launch.dryrun`) on the card:
   (1) smollm-360m at its published width and depth, bf16 weights from a
   seeded generator, one train step (`launch.steps.make_train_step`:
   forward, backward, clip, AdamW) at batch 4 x 1024 with no mesh
   installed, counted under `FakeTensorMode` on `cuda` and then for real
   under the same counter; (2) the GP predict cell (the mean-cache solve,
   `partitioned`, 20 fixed CG iterations) at n = 2^15 on a one-rank NCCL
   group, counted for real and, in a subprocess on a `fake` group of world
   1, on fake tensors. Gates: the FLOPs and bytes of the fake and the real
   count are equal (the same ops); the counted peak of (1) lies within 15%
   of `torch.cuda.max_memory_allocated` above the step's arguments.
   Printed: the counts, the collectives of both (the only part that may
   differ), the profiler's summed kernel time and the achieved TFLOP/s,
   and `t_compute` / `t_memory` of `roofline.analyze` (H100 SXM datasheet
   peaks). (3) `python -m repro_torch.launch.dryrun --arch
   smollm-360m,gp-exact-1m` on the (16, 16) fake mesh, started in a
   process of its own at the phase's start and collected at its end (it
   counts on the host's cores while (1) and (2) run, whose times are the
   card's own; phase 14's host-bound steps run with the host to
   themselves). Gate: every cell `ok`, long_500k `skipped`; each cell's
   roofline row and seconds printed.
14. The LM trainer: `launch.train`'s `main` in-process, `--full`, bf16
   weights and fp32 moments. smollm-360m at batch 8 x 1024: 3 steps with a
   checkpoint at 3, then a second call with the same `--ckpt` that resumes
   at step 3 and trains to 6 (gates: every loss finite, the mean of steps
   5-6 below step 1, the restored parameters equal the step-3 checkpoint
   bit for bit); a SIGTERM raised from a step hook during step 2 (gate: a
   final checkpoint at step 2, the loop stopped); a step function that
   returns a NaN loss once (gate: skipped once, the next step given the
   same state bit for bit). mamba2-130m at 8 x 1024 for 3 steps (the SSD
   backward; gate: finite losses). Printed: tokens/s at the median step
   and peak GiB per model beside the card's name and power limit, and
   each model's step at 8 x 1024 timed on the host clock beside its
   profiled kernel time (the card's busy share of a step).
14c. The sharded train step (the multi-rank LM path) on the card's
   one-rank NCCL group: smollm-360m at its published width and depth,
   bf16 weights, fp32 moments, 8 x 1024, the phase-14 stream. A (1, 1)
   `make_host_mesh`; the state placed as DTensors by
   `launch.steps.place_train_state`, the batches by `TokenPipeline` with
   the mesh; 3 steps through the sharded path and 3 through the plain one
   from the same state on the same batches. Gates: each step's loss
   within 3e-5 relative of the plain path's; after step 1 every parameter
   within 2e-4 of max|param|; only `shardctx.REPLICATE_OK` ops ran
   replicated; the sharded state's checkpoint (gathered, written by rank
   0) has the same arrays (shape, dtype, crc32 each) as the same state's
   as plain tensors, restores onto the plain path bit for bit, and one
   more step from it agrees on both paths. Printed: bit for bit or not,
   the median step ms of both paths, peak GiB and the ops that ran
   replicated, beside the card's name and power limit. Then a host-CPU
   check under the card host's own torch: a gloo world of 2 (spawned
   processes) runs one fp32 step at lr 1e-6 of reduced smollm-360m on
   (2, 1) and (1, 2) and of reduced granite-moe-3b-a800m on (1, 2),
   each against the one-rank step (loss, grad_norm, ce within 3e-5; the
   state within 2e-4 of max). Multi-card training itself needs a host
   with several cards (`scripts/torch_dist_check.py --lm`).
15. The phases' seconds beside the card's name and power limit (again, so
   the end of the output holds them), the `kernels` JSON line, then the
   last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Bounds: a kernel's `bound_ms` is the larger of its bytes (each input read
once, each output written once) over 3.35 TB/s and its operations over
67 TFLOP/s (H100 SXM fp32 outside the tensor cores, NVIDIA's data sheet);
B4 counts the operations of the entries its plan holds active; B3 counts
B1's operations and reads its accumulator once besides. `tc_bound_ms` is
the floor that knows the tensor cores, the larger of four times: the two
products (2d + 2t operations per entry) at 495 / 3 TFLOP/s (TF32 split in
three), the other operations at 67 TFLOP/s, the MUFU operations (exp,
sqrt and log, each counted per kind) at 16 per SM per clock on 132 SMs at
the card's maximum SM clock (`nvidia-smi --query-gpu=clocks.max.sm`), and
the bytes at 3.35 TB/s.
"""

from __future__ import annotations

import atexit
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
N_TRAIN = 1 << 16
DATA_SEED = 0
SPATIAL_N = 1 << 18
SPATIAL_TEST = 4096
FROM_DIR_QUERIES = 8192   # phase 4's queries for the from_dir engine
SPATIAL_EXPR = "matern32 * wendland2"
SPATIAL_STEPS = 2
CROSSCHECK_N = 1 << 13
DIST_GP_N = 98304          # n_train = 4/9 of 3 * DIST_GP_N = 2^17
DIST_STEPS = 3
RING_STEP = 1 << 17        # rows = chunk of one ring step, 8 cards at 2^20
DIST_N = 1 << 17           # rows of the distributed path's single-card pass
DKL_ARCH = "smollm-360m"   # phase 11's backbone, at its published width
DKL_N = 2048               # training sequences
DKL_TEST = 1024            # held-out sequences
DKL_SEQ = 64               # tokens per sequence
DKL_STEPS = 3
DKL_LR = 3e-3              # Adam's, over the backbone and the GP head
# phase 12: (arch, batch, prompt tokens, vlm patch positions), each at its
# published width and depth
SERVE_LM = (
    ("smollm-360m", 4, 256, 0),
    ("qwen2-moe-a2.7b", 4, 256, 0),
    ("mamba2-130m", 4, 1000, 0),       # not a multiple of ssm_chunk 256
    ("hymba-1.5b", 2, 1536, 0),        # past the 1024-token window
    ("seamless-m4t-large-v2", 4, 256, 0),
    ("qwen2-vl-7b", 4, 256, 64),
)
SERVE_GEN = 32             # tokens per sequence: prefill's + 31 decode steps
SERVE_CHECK_STEPS = 4      # decode steps held against the full forward
SERVE_LOGIT_TOL = 2e-3     # of max|logit| (tests/test_models_smoke.py:81)
SERVE_CPU_LAYERS = 2       # gate (d): card vs CPU at full width, this depth
SERVE_CPU_SHAPE = (2, 32)  # sequences x tokens
DEV = "cuda"
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_SPLIT_FLOPS = 495e12 / 3   # 3xTF32: three TF32 products per product
PEAK_BYTES = 3.35e12
SMS = 132
MUFU_PER_SM_CLOCK = 16
TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
# operations per (i, j) pair of the epilogue, by kernel kind (each add, mul,
# max, sqrt and exp counts one)
KIND_OPS = {"rbf": 2, "matern12": 3, "matern32": 6, "matern52": 9, "rq": 5,
            "wendland2": 8, "wendland4": 12}
# MUFU operations per (i, j) pair by kind: exp, and log for rq; the sqrt of
# d2 counts once per pair when any factor needs r
KIND_MUFU = {"rbf": 1, "matern12": 1, "matern32": 1, "matern52": 1, "rq": 2,
             "wendland2": 0, "wendland4": 0}
NEEDS_R = {"matern12", "matern32", "matern52", "wendland2", "wendland4"}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available")
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name} x{torch.cuda.device_count()} torch {torch.__version__} "
        f"cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(card_and_power_limit())
    return name


def card_and_power_limit() -> str:
    """The first card's `nvidia-smi` name and power limit."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return smi.splitlines()[0]


def phase_build() -> dict:
    """Build every kernel; print the build time, then the registers, stack
    and spill of each fp32 instance (ptxas) and its SASS counts."""
    from repro_torch.kernels import build

    info = build.build(force=True)
    log(f"[build] nvcc {info['seconds']:.1f} s -> {info['libs']}")
    return binary_summary(info)


def _case_inputs(m, n, d, t, dtype, seed):
    g = torch.Generator(device=DEV).manual_seed(seed)
    scale = 2.0 / math.sqrt(d)

    def arr(*shape, s=1.0):
        return s * torch.randn(shape, generator=g, device=DEV)

    return (arr(m, d, s=scale).to(dtype), arr(n, d, s=scale).to(dtype),
            arr(n, t).to(dtype), arr(m, t), arr(m, t))


SPECS = {
    "matern32": ((("matern32",),), [1.3, 1.0]),
    "rbf": ((("rbf",),), [0.8, 1.0]),
    "rq": ((("rq",),), [1.1, 1.0, 2.5]),
    "wendland2": ((("wendland2",),), [1.0, 0.05]),
    "0.5*rbf + matern32": ((("rbf",), ("matern32",)), [1.0, 1.0, 2.0, 0.6]),
}


def _compare(kmvm, components, scalars, Xi, Xj, V, Vrow, R):
    """(B1 rel err, B2 rel err, B1 max abs err, B2 max abs err)."""
    out = kmvm.kmvm_fused(components, Xi, Xj, V, scalars)
    out2, dots = kmvm.kmvm_fused_dots(components, Xi, Xj, V, Vrow, R, scalars)
    torch.cuda.synchronize()
    ref = kmvm.kmvm_plain(components, Xi, Xj, V, scalars)
    ref2, ref_dots = kmvm.kmvm_dots_plain(components, Xi, Xj, V, Vrow, R, scalars)

    def rel(a, b):
        return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))

    e1 = rel(out, ref)
    e2 = max([rel(out2, ref2)] + [rel(dots[q], ref_dots[q]) for q in range(4)])
    a1 = float(torch.max(torch.abs(out - ref)))
    a2 = float(torch.max(torch.abs(out2 - ref2)))
    return e1, e2, a1, a2


def _rel(a, b) -> float:
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


def _time_ms(fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


_SM_CLOCK_HZ = []


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, from nvidia-smi (read once)."""
    if not _SM_CLOCK_HZ:
        mhz = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True, text=True,
            check=True, timeout=60).stdout.split()[0]
        _SM_CLOCK_HZ.append(float(mhz) * 1e6)
    return _SM_CLOCK_HZ[0]


def _bounds(components, m, n, d, t, itemsize, dots: bool,
            entries: int | None = None, extra_bytes: int = 0) -> dict:
    """The least ms the card could take for one launch: `bound_ms` on fp32
    CUDA cores (the larger of the operations at 67 TFLOP/s and the bytes,
    and `bound_by` which), and `tc_bound_ms` with the two products on the
    tensor cores (the largest of the products at 3xTF32, the other
    operations at 67 TFLOP/s, the MUFU operations and the bytes).
    `entries`: the kernel entries the work holds (m n for the dense
    kernels, the plan's active entries for B4)."""
    count = m * n if entries is None else entries
    ops_pair = 2 * d + 2 * t + 4 + sum(
        2 + sum(1 + KIND_OPS[k] for k in kinds) for kinds in components)
    nbytes = (m + n) * d * itemsize + n * t * itemsize + m * t * 4 + extra_bytes
    if dots:
        nbytes += 2 * m * t * 4 + 4 * t * 4
    t_ops, t_bytes = ops_pair * count / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    kinds = [k for c in components for k in c]
    mufu = sum(KIND_MUFU[k] for k in kinds) + any(k in NEEDS_R for k in kinds)
    products = 2 * d + 2 * t
    tc = max(products * count / PEAK_TF32_SPLIT_FLOPS,
             (ops_pair - products) * count / PEAK_FP32_FLOPS,
             mufu * count / (MUFU_PER_SM_CLOCK * SMS * max_sm_clock_hz()),
             t_bytes)
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "tc_bound_ms": 1e3 * tc}


# the per-entry cost table: B1 at one launch shape, (d, spec, t) per row;
# the differences give one feature's, one epilogue factor's and K @ V's cost;
# then B2 and B3 beside B1 at d 9, matern32, t 1 and 9
COST_N = 1 << 16
COST_SPECS = {"rbf": ((("rbf",),), [1.0, 1.0]),
              "matern32": ((("matern32",),), [1.0, 1.0]),
              "matern32 * wendland2": ((("matern32", "wendland2"),),
                                       [1.0, 1.0, 0.25])}
COST_CASES = tuple(("kmvm", d, spec, 1) for d in (2, 9) for spec in COST_SPECS) + (
    ("kmvm", 9, "matern32", 9),) + tuple(
    (k, 9, "matern32", t) for k in ("kmvm_dots", "kmvm_chunk") for t in (1, 9))
KERNEL_LABEL = {"kmvm": "B1", "kmvm_dots": "B2", "kmvm_chunk": "B3"}


def kernel_call(kmvm, name, components, X, V, scalars, rows=None):
    """A no-argument call of B1, B2 or B3 over rows X[:rows] (all rows by
    default) against all of X: the residual and the row view are V's rows,
    B3 accumulates into a zero buffer it owns."""
    Xi = X if rows is None else X[:rows].contiguous()
    Vi = V[:Xi.shape[0]].contiguous()
    if name == "kmvm":
        return lambda: kmvm.kmvm_fused(components, Xi, X, V, scalars)
    if name == "kmvm_dots":
        return lambda: kmvm.kmvm_fused_dots(components, Xi, X, V, Vi, Vi, scalars)
    acc = torch.zeros((Xi.shape[0], V.shape[1]), device=X.device)
    return lambda: kmvm.kmvm_fused_chunk(components, Xi, X, V, scalars, acc)


def entry_cost_table() -> list:
    """ps per kernel entry at (COST_N, COST_N, d, t) for each case of
    COST_CASES (inputs N(0, 1/d) per feature, so distances are O(1))."""
    from repro_torch.kernels import kmvm

    rows = []
    for name, d, spec, t in COST_CASES:
        components, scal = COST_SPECS[spec]
        scalars = torch.tensor(scal, dtype=torch.float32, device=DEV)
        g = torch.Generator(device=DEV).manual_seed(17)
        X = torch.randn((COST_N, d), generator=g, device=DEV) / math.sqrt(d)
        V = torch.randn((COST_N, t), generator=g, device=DEV)
        ms = _time_ms(kernel_call(kmvm, name, components, X, V, scalars), 3)
        ps = ms * 1e9 / COST_N**2
        rows.append({"kernel": name, "d": d, "spec": spec, "t": t, "ms": ms,
                     "ps_per_entry": ps})
        log(f"[cost] {KERNEL_LABEL[name]} ({COST_N}, {COST_N}, d {d}, t {t}) "
            f"{spec}: {ms:.3f} ms, {ps:.3f} ps per entry")
    return rows


def _tool(name: str) -> str | None:
    """A CUDA binary tool: on PATH, in the toolkit, or in Triton's package."""
    found = shutil.which(name)
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)
    if os.path.exists(cand):
        return cand
    try:
        import triton
    except ImportError:
        return None
    cand = os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia",
                        "bin", name)
    return cand if os.path.exists(cand) else None


def _demangle(names: list) -> dict:
    filt = _tool("cu++filt") or shutil.which("c++filt")
    if not filt or not names:
        return {n: n for n in names}
    out = subprocess.run([filt], input="\n".join(names), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {n: n for n in names}


def _short(fn: str) -> str:
    """'kmvm_kernel<float, 1>' from a demangled template instance."""
    for junk in ("(anonymous namespace)::", "<unnamed>::", "(int)", "void "):
        fn = fn.replace(junk, "")
    fn = fn.replace("(bool)0", "false").replace("(bool)1", "true")
    return fn.replace("__nv_bfloat16", "bf16").split("(")[0].replace(" ", "")


def _ptxas_table(lines: list) -> dict:
    """{kernel: {"registers", "stack", "spill_stores", "spill_loads"}} from
    nvcc's -Xptxas -v lines."""
    import re

    table, cur = {}, None
    for ln in lines:
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = m.group(1)
            table.setdefault(cur, {})
            continue
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = m.group(1)
            table.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            table[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            table[cur]["registers"] = int(m.group(1))
    names = _demangle(list(table))
    return {_short(names[k]): v for k, v in table.items() if "kernel" in k}


def _sass_table(libs: list) -> dict:
    """Per kernel of the fp32 instances: SASS instructions, LDL/STL, MUFU,
    BAR and HMMA (tensor-core) counts, and the innermost and outermost
    loops holding MUFU ops with their LDS/STS counts (a loop: from a
    backward branch's target to the branch)."""
    import re

    tool = _tool("cuobjdump")
    if tool is None:
        return {"error": "cuobjdump not found"}
    funcs = {}
    for lib in libs:
        text = subprocess.run([tool, "-sass", lib], capture_output=True,
                              text=True, timeout=300).stdout
        cur = None
        for ln in text.splitlines():
            m = re.match(r"\s*Function : (\S+)", ln)
            if m:
                cur = m.group(1)
                funcs[cur] = []
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
            if cur is not None and m:
                funcs[cur].append((int(m.group(1), 16), m.group(2).strip()))
    names = _demangle(list(funcs))
    out = {}
    for raw, ins in funcs.items():
        name = _short(names[raw])
        if "bf16" in name or not re.search(r"<float,(1|16)(,\w+)*>", name):
            continue

        def count(sub, lo=-1, hi=1 << 62):
            return sum(1 for a, s in ins if lo <= a <= hi and re.search(sub, s))

        loops = []
        for a, s in ins:
            m = re.search(r"\bBRA\s+(?:`?\(?)(0x[0-9a-f]+)", s)
            if m and int(m.group(1), 16) < a:
                lo = int(m.group(1), 16)
                loops.append((a - lo, lo, a))
        def summary(lo, hi):
            return {"instructions": count(r".", lo, hi),
                    "mufu": count(r"\bMUFU\b", lo, hi),
                    "ldl_stl": count(r"\b(LDL|STL)\b", lo, hi),
                    "bar": count(r"\bBAR\b", lo, hi),
                    "hmma": count(r"\bHMMA\b", lo, hi),
                    "lds": count(r"\bLDS\b", lo, hi),
                    "sts": count(r"\bSTS\b", lo, hi)}

        with_mufu = [(lo, hi) for _, lo, hi in sorted(loops)
                     if count(r"\bMUFU\b", lo, hi)]
        out[name] = {"instructions": len(ins), "ldl": count(r"\bLDL\b"),
                     "stl": count(r"\bSTL\b"), "mufu": count(r"\bMUFU\b"),
                     "bar": count(r"\bBAR\b"), "hmma": count(r"\bHMMA\b"),
                     # innermost loop with MUFU ops: the per-entry code;
                     # outermost: the walk over column chunks
                     "entry_loop": summary(*with_mufu[0]) if with_mufu else None,
                     "chunk_loop": summary(*with_mufu[-1]) if with_mufu else None}
    return out


def binary_summary(info: dict) -> dict:
    """ptxas registers/stack/spill and the SASS counts of the fp32 B1, B2,
    B3 and B4 instances at t-chunks 1 and 16."""
    ptxas = {k: v for k, v in _ptxas_table(info["ptxas"]).items()
             if "bf16" not in k}
    sass = _sass_table(info["libs"])
    for name in sorted(set(ptxas) | set(sass)):
        log(f"[binary] {name}: ptxas {ptxas.get(name)}; sass {sass.get(name)}")
    return {"ptxas": ptxas, "sass": sass}


def phase_kernels(X_train) -> dict:
    from repro_torch.kernels import kmvm

    worst = {"kmvm": 0.0, "kmvm_dots": 0.0}
    cases = 0
    for spec, (components, scal) in SPECS.items():
        scalars = torch.tensor(scal, dtype=torch.float32, device=DEV)
        for dtype in (torch.float32, torch.bfloat16):
            for seed, (m, n, d, t) in enumerate(
                    ((100, 130, 9, 1), (257, 300, 9, 7), (64, 1000, 9, 128),
                     (33, 700, 385, 7), (130, 1025, 385, 128))):
                e1, e2, _, _ = _compare(kmvm, components, scalars,
                                        *_case_inputs(m, n, d, t, dtype, seed))
                tol = TOL[dtype]
                ok = e1 <= tol and e2 <= tol
                cases += 1
                worst["kmvm"] = max(worst["kmvm"], e1 / tol)
                worst["kmvm_dots"] = max(worst["kmvm_dots"], e2 / tol)
                if not ok:
                    raise SystemExit(
                        f"[kernels] MISMATCH {spec} {dtype} {(m, n, d, t)}: "
                        f"B1 {e1:.2e} B2 {e2:.2e} > {tol}")
    log(f"[kernels] {cases} cases match their plain versions "
        f"(worst error / tolerance: B1 {worst['kmvm']:.3f}, "
        f"B2 {worst['kmvm_dots']:.3f})")

    # the main path: matern32 pre-scaled by lengthscale sqrt(d), weight 1
    components = (("matern32",),)
    scalars = torch.tensor([1.0, 1.0], dtype=torch.float32, device=DEV)
    n, d = X_train.shape
    Xs = (X_train / math.sqrt(d)).contiguous()
    g = torch.Generator(device=DEV).manual_seed(7)
    v1 = torch.randn((n, 1), generator=g, device=DEV)
    v128 = torch.randn((n, 128), generator=g, device=DEV)
    r1 = torch.randn((n, 1), generator=g, device=DEV)
    abs_err = {}
    for t, V in ((1, v1), (128, v128)):
        e1, e2, a1, a2 = _compare(kmvm, components, scalars, Xs[:2048], Xs, V,
                                  V[:2048].contiguous(), r1[:2048].expand(2048, t).contiguous())
        if not (e1 <= TOL[torch.float32] and e2 <= TOL[torch.float32]):
            raise SystemExit(f"[kernels] MISMATCH main path (2048, {n}, {d}, {t}): "
                             f"B1 {e1:.2e} B2 {e2:.2e}")
        abs_err[t] = (a1, a2)
        log(f"[kernels] main path (2048, {n}, {d}, {t}) fp32: B1 rel {e1:.2e} "
            f"abs {a1:.2e}, B2 rel {e2:.2e} abs {a2:.2e}")

    # B1 and B2 at the serving shape, B1 at a prediction chunk, then both at
    # the distributed path's single-card shape (2^17 rows of d = 9: its
    # Lanczos pass and the fit's CG steps; random rows of the same scale)
    rows = time_square(components, scalars, Xs, v1, r1, plain_reps=2)
    pred = Xs[:1024].contiguous()
    rows["kmvm"].append(_time_row(
        "kmvm", (1024, n, d, 128), components,
        lambda: kmvm.kmvm_fused(components, pred, Xs, v128, scalars),
        lambda: kmvm.kmvm_plain(components, pred, Xs, v128, scalars), 10, 5))
    X2 = torch.randn((DIST_N, d), generator=g, device=DEV) / math.sqrt(d)
    w1 = torch.randn((DIST_N, 1), generator=g, device=DEV)
    s1 = torch.randn((DIST_N, 1), generator=g, device=DEV)
    for name, more in time_square(components, scalars, X2, w1, s1).items():
        rows[name] += more
    del X2, w1, s1
    return {"rows": rows, "abs_err": abs_err, "worst": worst,
            "costs": entry_cost_table()}


# B5 at the training shape: he-train's matern32 hyperparameters (the
# benchmark's houseelectric-2e16), 1 + 8 probe column pairs
KGRAD_HYP = {"lengthscale": 2.4557, "outputscale": 0.6140, "noise": 0.0646}
KGRAD_T = 9


def phase_kgrad(X_train) -> dict:
    """B5 (`kernels.kgrad`, the Eq. 2 backward's kernel) at (n, n, d, 9
    column pairs): against its plain version in fp64, timed beside that
    plain version in fp32 and beside the autograd loop it replaces
    (`partitioned.quad_form_partials` at the pallas operator's 512-row
    blocks), with the host's chain rule (`ops.kgrad_grads`)."""
    from repro_torch.core import partitioned
    from repro_torch.core.kernels_math import init_params
    from repro_torch.kernels import kgrad
    from repro_torch.kernels.ops import kgrad_grads, kgrad_pass_or_none

    n, d = X_train.shape
    params = init_params(device=DEV, **KGRAD_HYP)
    ppass = kgrad_pass_or_none("matern32", params, d)
    Xs = (X_train / ppass.lengthscale).contiguous()
    scalars = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=DEV)
                           for v in ppass.scalars])
    g = torch.Generator(device=DEV).manual_seed(11)
    A = torch.randn((n, KGRAD_T), generator=g, device=DEV)
    V = torch.randn((n, KGRAD_T), generator=g, device=DEV)
    comps = ppass.components
    out = kgrad.kgrad_fused(comps, Xs, A, V, scalars)
    want = kgrad.kgrad_plain(comps, Xs.double(), A.double(), V.double(),
                             scalars.double())
    rel = float(((out.double() - want).abs() / want.abs()).max())
    if rel > 1e-4:
        raise SystemExit(f"[kgrad] MISMATCH {tuple(out.tolist())} vs {tuple(want.tolist())}")
    ms = _time_ms(lambda: kgrad.kgrad_fused(comps, Xs, A, V, scalars), 5)
    grads_ms = _time_ms(lambda: kgrad_grads("matern32", X_train, A, V, params), 3)

    def once(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    plain_ms = once(lambda: kgrad.kgrad_plain(comps, Xs, A, V, scalars))
    autograd_ms = once(lambda: partitioned.quad_form_partials(
        "matern32", X_train, X_train, A, V, params, row_block=512))
    row = {"shape": (n, n, d, KGRAD_T), "ms": ms, "grads_ms": grads_ms,
           "plain_ms": plain_ms, "autograd_ms": autograd_ms, "max_rel_err": rel,
           **_bounds(comps, n, n, d, KGRAD_T, 4, False)}
    log(f"[kgrad] {json.dumps(row)}")
    return row


def _time_row(name, shape, components, kern, plain, reps, plain_reps) -> dict:
    """One timing row: the kernel against its plain version (2e-4 of
    max|out|), then both timed with CUDA events, beside the bound."""
    err = _rel(kern(), plain())
    if not err <= TOL[torch.float32]:
        raise SystemExit(f"[kernels] MISMATCH {name} {shape}: {err:.2e}")
    ms = _time_ms(kern, reps)
    plain_ms = _time_ms(plain, plain_reps)
    b = _bounds(components, *shape, 4, name == "kmvm_dots")
    log(f"[kernels] time {name} {shape}: {ms:.3f} ms (bound {b['bound_ms']:.3f} "
        f"ms, {b['bound_ms'] / ms:.1%} of it; tc bound {b['tc_bound_ms']:.3f} "
        f"ms), plain {plain_ms:.3f} ms, rel err {err:.2e}")
    return {"shape": list(shape), "ms": ms, "plain_ms": plain_ms, **b,
            "rel_err": err}


def time_square(components, scalars, X, v, r, reps=3, plain_reps=1) -> dict:
    """B1 and B2 at (n, n, d, 1) with X as rows and columns, v the RHS and
    r the CG residual: {"kmvm": row, "kmvm_dots": row} of lists."""
    from repro_torch.kernels import kmvm

    n, d = X.shape
    return {
        "kmvm": [_time_row(
            "kmvm", (n, n, d, 1), components,
            lambda: kmvm.kmvm_fused(components, X, X, v, scalars),
            lambda: kmvm.kmvm_plain(components, X, X, v, scalars), reps,
            plain_reps)],
        "kmvm_dots": [_time_row(
            "kmvm_dots", (n, n, d, 1), components,
            lambda: kmvm.kmvm_fused_dots(components, X, X, v, v, r, scalars)[0],
            lambda: kmvm.kmvm_dots_plain(components, X, X, v, v, r, scalars)[0],
            reps, plain_reps)]}


def from_dir_check(tag, art_dir, Xq, want, counts, kernel) -> dict:
    """`PredictionEngine.from_dir(art_dir)` on the card: its `predict_mean`
    on the queries must equal `want`, the means of an engine built on
    `load_artifact` the existing way, bit for bit. `counts` is the kernel
    module whose launch counts are set to 0 just before `predict_mean` and
    read just after; `kernel` must have been launched."""
    from repro_torch.kernels.ops import mvm_plan
    from repro_torch.serve import PredictionEngine

    engine = PredictionEngine.from_dir(art_dir, chunk_size=1024, device=DEV)
    engine.warmup()
    torch.cuda.synchronize()
    counts.reset_launch_counts()
    got = engine.predict_mean(Xq)
    torch.cuda.synchronize()
    launches = dict(counts.launch_counts)
    op = engine.op
    passes = mvm_plan(op.kernel, op.params).num_fused_passes
    same = bool(torch.equal(got, want))
    log(f"[{tag}] from_dir engine: backend {engine.backend}, kernel "
        f"{op.kernel}, fused passes {passes}, device {op.device}; "
        f"predict_mean on {Xq.shape[0]} queries equals the load_artifact "
        f"engine's means bit for bit: {same} (max abs "
        f"{float(torch.max(torch.abs(got - want))):.3e}); launches {launches}")
    if not same:
        raise SystemExit(f"[{tag}] from_dir predict_mean differs from the "
                         f"load_artifact engine's means")
    if launches[kernel] <= 0:
        raise SystemExit(f"[{tag}] {kernel} was never launched by the "
                         f"from_dir engine: {launches}")
    return {"backend": engine.backend, "fused_passes": passes,
            "launches": launches, "bitwise": same}


def phase_serve(X_test) -> dict:
    """The `serve_gp` launcher twice: closed (train, fit, save, serve through
    the MicroBatcher), then the continuous fleet on the saved artifact with
    two models and a 64-row `observe`. The counts are set to 0 just before
    each run and read just after it."""
    from repro_torch.kernels import kmvm
    from repro_torch.launch import serve_gp

    art_dir = os.path.join(HERE, "build", "smoke_artifact")
    shutil.rmtree(art_dir, ignore_errors=True)
    common = ["--backend", "pallas", "--dataset", "houseelectric",
              "--n", str(N_TRAIN), "--seed", str(DATA_SEED),
              "--artifact", art_dir, "--chunk", "1024", "--requests", "200",
              "--points-per-request", "8", "--clients", "8", "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    kmvm.reset_launch_counts()
    report = serve_gp.main(common)
    torch.cuda.synchronize()
    launches = dict(kmvm.launch_counts)
    report["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    log(f"[serve] n={report['n']} d={report['d']} trained in "
        f"{report['train_s']:.2f} s: {report['hyperparameters']} (final loss "
        f"{report['final_loss']:.5f}, launches {report['train_launches']}); "
        f"precompute {report['precompute_s']:.2f} s, rel residual "
        f"{report['rel_residual']:.3e}, CG steps (B2 launches) "
        f"{report['fit_launches']['kmvm_dots']}, fit launches "
        f"{report['fit_launches']}, verify {report['verify_rel_err']:.2e}")
    log(f"[serve] closed: p50 {report['p50_ms']:.2f} ms p99 "
        f"{report['p99_ms']:.2f} ms max {report['max_ms']:.2f} ms qps "
        f"{report['qps']:.1f} over {report['batches']} batches "
        f"({report['req_per_batch']:.2f} req/batch, {report['rows_padded']} "
        f"padded rows); peak memory "
        f"{report['max_memory_allocated'] / 2**30:.2f} GiB; launches {launches}")
    if not report["rel_residual"] <= 0.01:
        raise SystemExit(f"[serve] mean solve residual {report['rel_residual']} > 0.01")
    if not report["verify_rel_err"] <= 1e-5:
        raise SystemExit(f"[serve] verification {report['verify_rel_err']} > 1e-5")
    for name in ("kmvm", "kmvm_dots"):
        if launches[name] <= 0:
            raise SystemExit(f"[serve] kernel {name} was never launched on the "
                             f"main path")
    report["launches_total"] = launches
    report["artifact"] = art_dir

    # the saved artifact through `PredictionEngine.from_dir`, against an
    # engine built on `load_artifact` as the launcher builds its own
    from repro_torch.serve import PredictionEngine, load_artifact

    Xq = torch.as_tensor(np.asarray(X_test[:FROM_DIR_QUERIES], np.float32),
                         device=DEV)
    existing = PredictionEngine(load_artifact(art_dir, device=DEV),
                                chunk_size=1024, device=DEV)
    want = existing.predict(Xq)[0]
    del existing
    report["from_dir"] = from_dir_check("serve", art_dir, Xq, want, kmvm,
                                        "kmvm")

    kmvm.reset_launch_counts()
    t0 = time.perf_counter()
    fleet = serve_gp.main(common + ["--scheduler", "continuous", "--models", "2",
                                    "--workers", "2", "--observe", "64"])
    torch.cuda.synchronize()
    fleet["path_s"] = time.perf_counter() - t0
    fleet["launches_total"] = dict(kmvm.launch_counts)
    obs_ = fleet["observe"]
    check = fleet["fleet_vs_engine"]
    models = {k: {f: v[f] for f in ("count", "p50_ms", "p99_ms", "qps")}
              for k, v in fleet["models"].items()}
    log(f"[serve] fleet: p50 {fleet['p50_ms']:.2f} ms p99 {fleet['p99_ms']:.2f}"
        f" ms max {fleet['max_ms']:.2f} ms qps {fleet['qps']:.1f} over "
        f"{fleet['batches']} batches ({fleet['req_per_batch']:.2f} req/batch, "
        f"{fleet['rows_padded']} padded rows); per model {models}; fleet vs "
        f"engine on 64 queries: mean bit for bit {check['mean_bitwise']} "
        f"(max abs {check['mean_max_abs']:.3e}), var {check['var_rel']:.2e}")
    log(f"[serve] observe(64): update {obs_['update_s']:.3f} s vs cold refit "
        f"{obs_['refit_s']:.3f} s ({obs_['update_vs_refit']:.2%}); CG "
        f"iterations warm {obs_['warm_iters']} vs cold {obs_['cold_iters']}; "
        f"residual {obs_['update_rel_residual']:.3e} (tol {obs_['pred_tol']}); "
        f"rank {obs_['update_rank']}; mean vs refit {obs_['mean_vs_refit']:.3e}"
        f"; launches during the update {obs_['observe_launches']}; a request "
        f"to m1 waited {obs_['lock_wait_ms']:.1f} ms; path "
        f"{fleet['path_s']:.1f} s, launches {fleet['launches_total']}")
    gates = {
        "B2 launched during observe": obs_["observe_launches"]["kmvm_dots"] > 0,
        "B1 and B2 launched on the fleet path":
            min(fleet["launches_total"]["kmvm"],
                fleet["launches_total"]["kmvm_dots"]) > 0,
        "update residual <= pred_tol":
            obs_["update_rel_residual"] <= obs_["pred_tol"],
        "warm CG iterations < cold": obs_["warm_iters"] < obs_["cold_iters"],
        "fleet mean equals the engine's bit for bit": check["mean_bitwise"],
        "fleet variance within 1e-5 of the engine's": check["var_rel"] <= 1e-5,
        "updated mean within 3e-2 of the cold refit's":
            obs_["mean_vs_refit"] <= 3e-2,
        "updated variances finite and > 0": obs_["var_finite_positive"],
    }
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise SystemExit(f"[serve] fleet gates failed: {failed}")
    report["fleet"] = fleet
    return report


AUTOTUNE_T = (1, 9)        # the exact GP's solves (t = 1) and mBCG (y + 8 probes)
SGPR_M, SGPR_STEPS = 512, 100            # the paper's SGPR settings
SVGP_M, SVGP_BATCH, SVGP_EPOCHS = 1024, 1024, 100   # and SVGP's
SUBSET, SUBSETS = 4096, 4  # rows and count of the card-vs-CPU loss checks


def _turns(fns: dict, reps: int) -> dict:
    """ms of each no-argument call, timed in turns a, b, b, a (CUDA events)
    and averaged over the two turns of each."""
    names = list(fns)
    order = names + names[::-1]
    ms = {k: [] for k in names}
    for k in order:
        ms[k].append(_time_ms(fns[k], reps))
    return {k: sum(v) / len(v) for k, v in ms.items()}


def phase_autotune(art, y, X_test) -> dict:
    """The column-split autotuner at the exact GP's shapes: a sweep per t
    into a fresh cache under build/, its memo and disk hits; B1 and B2 at
    every candidate split against their plain versions; the row-count and
    B2 == B1 pins at the tuned split; tuned against default split times;
    then `fit_posterior` on an autotune=True operator against the phase-4
    artifact (the default split)."""
    from repro_torch import obs
    from repro_torch.core.operators import make_operator
    from repro_torch.core.predcache import predict_mean
    from repro_torch.kernels import autotune, kmvm
    from repro_torch.serve import fit_posterior

    cdir = os.path.join(HERE, "build", "autotune_cache")
    shutil.rmtree(cdir, ignore_errors=True)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = cdir   # the operator's sweeps too
    autotune.clear_memo()
    components = (("matern32",),)
    n, d = art.X.shape
    fp32 = dict(compute_dtype="float32")
    out = {"splits": {}, "timings": {}, "sweep_ms": {}, "sweep_launches": {}}
    for t in AUTOTUNE_T:
        obs.registry().reset("autotune.")
        kmvm.reset_launch_counts()
        split = autotune.autotune_tiles(components, n, n, d, t, **fp32)
        torch.cuda.synchronize()
        out["sweep_launches"][t] = dict(kmvm.launch_counts)
        first = obs.registry().snapshot()
        again = autotune.autotune_tiles(components, n, n, d, t, **fp32)
        memo = obs.registry().snapshot()
        autotune.clear_memo()
        disk = autotune.autotune_tiles(components, n, n, d, t, **fp32)
        snap = obs.registry().snapshot()
        key = autotune.cache_key(components, n, n, d, t, **fp32)
        with open(os.path.join(cdir, autotune.key_hash(key) + ".json")) as f:
            entry = json.load(f)
        out["splits"][t] = split
        out["timings"][t] = entry["timings"]
        out["sweep_ms"][t] = first["autotune.sweep_ms"]["sum"]
        log(f"[autotune] ({n}, {n}, d {d}, t {t}) -> key buckets n {key['n']} "
            f"d {key['d']} t {key['t']}: tiles per split "
            + ", ".join(f"{c}: {1e3 * s:.3f} ms" for c, s in
                        entry["timings"].items())
            + f" (B1 + B2 at the key's shape; 0 = one split) -> chosen {split}; "
            f"sweep {out['sweep_ms'][t]:.0f} ms, launches "
            f"{out['sweep_launches'][t]}")
        gates = {
            "one sweep, one miss": first["autotune.sweeps"] == 1
            and first["autotune.misses"] == 1,
            "second call hits the memo": again == split
            and memo["autotune.hits"] == 1 and memo["autotune.sweeps"] == 1,
            "third call hits the disk": disk == split
            and snap["autotune.hits"] == 2 and snap["autotune.sweeps"] == 1,
        }
        failed = [k for k, ok in gates.items() if not ok]
        if failed:
            raise SystemExit(f"[autotune] cache gates failed at t {t}: {failed}")

    # every candidate against the plain version; the pins at the tuned split
    scalars = torch.tensor([1.0, 1.0], dtype=torch.float32, device=DEV)
    Xs = (art.X / math.sqrt(d)).contiguous()
    g = torch.Generator(device=DEV).manual_seed(11)
    worst, abs_err = 0.0, {}
    rows = min(2048, n)
    for t in AUTOTUNE_T:
        V = torch.randn((n, t), generator=g, device=DEV)
        R = torch.randn((rows, t), generator=g, device=DEV)
        Xi, Vi = Xs[:rows].contiguous(), V[:rows].contiguous()
        ref = kmvm.kmvm_plain(components, Xi, Xs, V, scalars)
        for c in autotune.DEFAULT_CANDIDATES:
            o1 = kmvm.kmvm_fused(components, Xi, Xs, V, scalars, c)
            o2, _ = kmvm.kmvm_fused_dots(components, Xi, Xs, V, Vi, R, scalars, c)
            e = max(_rel(o1, ref), _rel(o2, ref))
            worst = max(worst, e)
            if not e <= TOL[torch.float32]:
                raise SystemExit(f"[autotune] MISMATCH split {c} t {t}: {e:.2e}")
        c = out["splits"][t]
        o1 = kmvm.kmvm_fused(components, Xi, Xs, V, scalars, c)
        o2, _ = kmvm.kmvm_fused_dots(components, Xi, Xs, V, Vi, R, scalars, c)
        s1 = kmvm.kmvm_fused(components, Xi[:64].contiguous(), Xs, V, scalars, c)
        s2, _ = kmvm.kmvm_fused_dots(components, Xi[:64].contiguous(), Xs, V,
                                     Vi[:64].contiguous(), R[:64].contiguous(),
                                     scalars, c)
        full1 = kmvm.kmvm_fused(components, Xs, Xs, V, scalars, c)
        full2, _ = kmvm.kmvm_fused_dots(components, Xs, Xs, V, V, V, scalars, c)
        pins = {"64-row B1 rows == 2048-row B1 rows": torch.equal(s1, o1[:64]),
                "64-row B2 rows == 2048-row B2 rows": torch.equal(s2, o2[:64]),
                "B2 == B1 (2048 rows)": torch.equal(o1, o2),
                "B2 == B1 (all rows)": torch.equal(full1, full2),
                "2048 of all rows == 2048-row launch": torch.equal(full1[:rows], o1)}
        failed = [k for k, ok in pins.items() if not ok]
        if failed:
            raise SystemExit(f"[autotune] pins failed at split {c}, t {t}: {failed}")
        abs_err[t] = float(torch.max(torch.abs(o1 - ref)))
        # tuned against default, in turns, at the real shape (n, n, d, t)
        default = kmvm._SPLIT_TILES
        fns = {f"B1 split {default}":
               lambda: kmvm.kmvm_fused(components, Xs, Xs, V, scalars, default),
               f"B1 split {c} (tuned)":
               lambda: kmvm.kmvm_fused(components, Xs, Xs, V, scalars, c),
               f"B2 split {default}":
               lambda: kmvm.kmvm_fused_dots(components, Xs, Xs, V, V, V, scalars,
                                            default),
               f"B2 split {c} (tuned)":
               lambda: kmvm.kmvm_fused_dots(components, Xs, Xs, V, V, V, scalars, c)}
        ms = _turns(fns, 5)
        out["timings"][f"real_t{t}"] = ms
        b = _bounds(components, n, n, d, t, 4, True)
        log(f"[autotune] ({n}, {n}, {d}, {t}) default vs tuned, in turns: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
            + f"; B2 bound {b['bound_ms']:.3f} ms; pins hold at split {c}")
    log(f"[autotune] {len(autotune.DEFAULT_CANDIDATES)} candidates x t "
        f"{AUTOTUNE_T} on 2048 rows match the plain version (worst rel "
        f"{worst:.2e}, tolerance {TOL[torch.float32]})")
    out["worst_rel_err"], out["abs_err"] = worst, abs_err

    # the exact GP's precompute on an autotuned operator
    op_tuned = make_operator(art.config._replace(autotune=True), art.X,
                             art.params, device=DEV)
    op_default = make_operator(art.config, art.X, art.params, device=DEV)
    kmvm.reset_launch_counts()
    obs.registry().reset("autotune.")
    t0 = time.perf_counter()
    fit = fit_posterior(op_tuned, y,
                        generator=torch.Generator(device=DEV).manual_seed(0),
                        precond_rank=art.meta["precond_rank"],
                        lanczos_rank=art.meta["lanczos_rank"],
                        pred_tol=art.meta["pred_tol"],
                        max_cg_iters=art.meta["max_cg_iters"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(kmvm.launch_counts)
    hits = obs.registry().snapshot().get("autotune.hits", 0)
    Xq = torch.as_tensor(X_test[:512], dtype=torch.float32, device=DEV)
    m_tuned = predict_mean(op_tuned, Xq, fit.cache())
    m_default = predict_mean(op_default, Xq, art.cache())
    diff = _rel(m_tuned, m_default)
    res = fit.meta["solve_rel_residual"]
    log(f"[autotune] fit_posterior on the autotuned operator: {fit_s:.2f} s, "
        f"residual {res:.3e}, launches {launches}, autotune hits {hits}; "
        f"mean vs the default split's artifact {diff:.3e} of max|mean|")
    gates = {"residual <= 0.01": res <= 0.01,
             "B1 and B2 launched": min(launches["kmvm"], launches["kmvm_dots"]) > 0,
             "the operator read the tuned split": hits > 0,
             "mean within 3e-2 of the default split's": diff <= 3e-2}
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise SystemExit(f"[autotune] fit gates failed: {failed}")
    out.update(fit_s=fit_s, fit_residual=res, fit_launches=launches,
               mean_vs_default=diff)
    return out


def _params_to(params, device, dtype):
    from repro_torch.core.kernels_math import params_map

    return params_map(lambda a: a.detach().to(device, dtype), params)


def phase_table1(serve: dict, art, s) -> dict:
    """The paper's Table 1 on the houseelectric analogue (phase 4's draw):
    the exact GP (phase 4's trained artifact through the engine), SGPR and
    SVGP at the paper's widths, fp32; then examples/quickstart_torch.py."""
    import importlib.util

    from repro_torch.core.gp import gaussian_nll, rmse
    from repro_torch.core.sgpr import sgpr_loss, sgpr_precompute, sgpr_predict
    from repro_torch.core.svgp import svgp_loss, svgp_predict
    from repro_torch.serve import PredictionEngine
    from repro_torch.train.gp_trainer import fit_sgpr, fit_svgp

    X = torch.as_tensor(s.X_train[:N_TRAIN], dtype=torch.float32, device=DEV)
    y = torch.as_tensor(s.y_train[:N_TRAIN], dtype=torch.float32, device=DEV)
    Xt = torch.as_tensor(s.X_test, dtype=torch.float32, device=DEV)
    yt = torch.as_tensor(s.y_test, dtype=torch.float32, device=DEV)
    rows = {}

    def row(name, mean, var, train_s, per: str, peak):
        rows[name] = {"rmse": float(rmse(mean, yt)),
                      "nll": float(gaussian_nll(mean, var, yt)),
                      "train_s": train_s, "per": per, "peak_gib": peak / 2**30}
        r = rows[name]
        log(f"[table1] {name}: test rmse {r['rmse']:.5f}, nll {r['nll']:.5f}, "
            f"train {train_s:.2f} s ({per}), peak {r['peak_gib']:.2f} GiB")

    torch.cuda.reset_peak_memory_stats()
    engine = PredictionEngine(art, chunk_size=1024, device=DEV)
    mean, var = engine.predict(Xt)
    torch.cuda.synchronize()
    row("exact", mean, var, serve["train_s"],
        "phase 4: subset pretraining and 2 full-data steps; precompute "
        f"{serve['precompute_s']:.2f} s",
        max(serve["max_memory_allocated"], torch.cuda.max_memory_allocated()))

    torch.cuda.reset_peak_memory_stats()
    sp, sgpr_trace, secs = fit_sgpr("matern32", X, y, SGPR_M, steps=SGPR_STEPS,
                                    device=DEV)
    cache = sgpr_precompute("matern32", X, y, sp)
    ms, vs = sgpr_predict("matern32", Xt, sp, cache)
    torch.cuda.synchronize()
    row("sgpr", ms, vs, secs, f"{secs / SGPR_STEPS:.4f} s per step",
        torch.cuda.max_memory_allocated())

    torch.cuda.reset_peak_memory_stats()
    vp, svgp_trace, secs = fit_svgp("matern32", X, y, SVGP_M, epochs=SVGP_EPOCHS,
                                    batch=SVGP_BATCH, lr=0.01, device=DEV)
    mv, vv = svgp_predict("matern32", Xt, vp)
    torch.cuda.synchronize()
    row("svgp", mv, vv, secs, f"{secs / SVGP_EPOCHS:.4f} s per epoch of "
        f"{N_TRAIN // SVGP_BATCH} steps", torch.cuda.max_memory_allocated())

    # the losses on 4096-row subsets, the card against the CPU from the same
    # (trained, fp32) params, in fp64, where rounding cannot hide a
    # difference in the function. The fp32 values are printed beside it with
    # their distance from the fp64 one on each device: the trained SVGP loss
    # is small (about 0.06), and its fp32 value lies 1e-4..1e-3 of itself
    # from the fp64 one on either device, with the order of the sums
    # (PERF.md)
    fns = {"sgpr": lambda X_, y_, p: sgpr_loss("matern32", X_, y_, p),
           "svgp": lambda X_, y_, p: svgp_loss("matern32", X_, y_, p, N_TRAIN)}
    losses = {}
    for k, p in (("sgpr", sp), ("svgp", vp)):
        for i in range(SUBSETS):
            rows_ = slice(i * SUBSET, (i + 1) * SUBSET)
            vals = {}
            for where, dev in (("card", DEV), ("cpu", "cpu")):
                for dt in (torch.float32, torch.float64):
                    vals[f"{where}{str(dt)[-2:]}"] = float(
                        fns[k](X[rows_].to(dev, dt), y[rows_].to(dev, dt),
                               _params_to(p, dev, dt)))
            ref = vals["cpu64"]
            vals.update({f"rel_{a}": abs(vals[a] - ref) / abs(ref)
                         for a in ("card32", "cpu32", "card64")})
            vals["rel_card32_cpu32"] = abs(
                vals["card32"] - vals["cpu32"]) / abs(vals["cpu32"])
            losses[f"{k}{i}"] = vals
            log(f"[table1] {k}_loss on rows {rows_.start}:{rows_.stop} from the "
                f"trained params: fp64 card {vals['card64']:.9f} CPU {ref:.9f} "
                f"(rel {vals['rel_card64']:.2e}); fp32 card {vals['card32']:.7f}"
                f" CPU {vals['cpu32']:.7f} (rel {vals['rel_card32_cpu32']:.2e}),"
                f" from fp64: card {vals['rel_card32']:.2e}, CPU "
                f"{vals['rel_cpu32']:.2e}")
    log(f"[table1] SGPR loss {sgpr_trace[0]:.5f} -> {sgpr_trace[-1]:.5f}, "
        f"SVGP epoch loss {svgp_trace[0]:.5f} -> {svgp_trace[-1]:.5f}")
    beats = rows["exact"]["rmse"] < min(rows["sgpr"]["rmse"], rows["svgp"]["rmse"])
    log(f"[table1] exact GP rmse below both baselines: {beats}")

    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", os.path.join(HERE, "examples", "quickstart_torch.py"))
    quick = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quick)
    qrows = quick.main(["--device", DEV, "--artifact",
                        os.path.join(HERE, "build", "quickstart_artifact")])
    for name in ("exact", "sgpr", "svgp"):
        r = qrows[name]
        log(f"[table1] quickstart {name}: rmse {r['rmse']:.4f} nll "
            f"{r['nll']:.4f} ({r['seconds']:.2f} s train)")
    values = ([v for r in rows.values() for v in (r["rmse"], r["nll"])]
              + sgpr_trace + svgp_trace
              + [v for d in losses.values() for v in d.values()]
              + [v for r in qrows.values() for v in (r["rmse"], r["nll"])])
    gates = {"every loss, rmse and nll finite": all(map(math.isfinite, values)),
             "SGPR's last loss below its first": sgpr_trace[-1] < sgpr_trace[0],
             "SVGP's last epoch below its first": svgp_trace[-1] < svgp_trace[0],
             "subset losses card == CPU within 1e-4 (fp64, same params)":
                 max(d["rel_card64"] for d in losses.values()) <= 1e-4}
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise SystemExit(f"[table1] gates failed: {failed}")
    return {"rows": rows, "quickstart": qrows, "subset_losses": losses,
            "exact_beats_both": beats}


PHASES = ("precond_build", "cg_solve", "slq_logdet", "eq2_backward")
PHASE4C_SPANS = {"fit_exact_gp", "optimizer_step", "mll_step", *PHASES}


def phase_traced_fit(s) -> dict:
    """Phase 4c: phase 4's training (`fit_exact_gp` as serve_gp runs it) on
    phase 4's draw, untraced and then traced with the health sink and
    profiling on, from the same seed and initial parameters; the trace
    through `obs_report --compare-model --health`; then one traced cold
    `WarmStartEngine.step` at the trained parameters under
    whose B1 + B2 launches must equal its cg_solve span's modeled
    launches, and whose Eq. 2 backward must be one B5 launch on the fused
    route."""
    from repro_torch import obs
    from repro_torch.core.gp import ExactGP, ExactGPConfig
    from repro_torch.kernels import kgrad, kmvm
    from repro_torch.launch import obs_report
    from repro_torch.obs import health
    from repro_torch.obs.measure import phase_model_comparison
    from repro_torch.obs.report import assign_self_times, load_trace, phase_breakdown
    from repro_torch.train.gp_trainer import GPTrainConfig, fit_exact_gp
    from repro_torch.train.solver_state import WarmStartEngine

    X = torch.as_tensor(s.X_train[:N_TRAIN], dtype=torch.float32, device=DEV)
    y = torch.as_tensor(s.y_train[:N_TRAIN], dtype=torch.float32, device=DEV)
    # phase 4's training configuration (`launch/serve_gp.py`)
    gp = ExactGP(ExactGPConfig(kernel="matern32", backend="pallas",
                               row_block=512, precond_rank=100,
                               lanczos_rank=128), device=DEV)
    cfg = GPTrainConfig(pretrain_subset=512, pretrain_lbfgs_steps=3,
                        pretrain_adam_steps=3, finetune_adam_steps=2)
    params0 = gp.init_params(X.shape[1], noise=0.5, dtype=X.dtype)

    def fit():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit_exact_gp(gp, X, y, cfg=cfg, params0=params0, device=DEV)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    res0, plain_s = fit()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    tpath, hpath = os.path.join(tmp, "trace.jsonl"), os.path.join(tmp, "health.jsonl")
    obs.registry().reset()
    health.enable_health(hpath)
    obs.enable_profiling()
    with obs.trace_session(tpath):
        res1, traced_s = fit()
        mem = obs.memory_snapshot("phase4c")
    obs.disable_profiling()
    health.disable_health()

    modes0 = [t["mode"] for t in res0.telemetry]
    modes1 = [t["mode"] for t in res1.telemetry]
    loss_rel = max(abs(a - b) / max(abs(a), 1e-30)
                   for a, b in zip(res0.loss_trace, res1.loss_trace))
    events, _ = load_trace(tpath)
    spans = assign_self_times(events)
    names = {sp.name for sp in spans}
    # the phase table's self-times add up to the root's wall by construction
    # (the root keeps what its children do not cover): printed, not gated
    rows, wall = phase_breakdown(spans, root="fit_exact_gp")
    covered = sum(r.self_ms for r in rows)
    # the fenced phase spans against the mll_step spans that hold them: work
    # that escaped a phase's fence would land in mll_step's own time
    mll_ms = sum(sp.dur for sp in spans if sp.name == "mll_step") / 1e3
    phase_ms = sum(sp.dur for sp in spans if sp.name in PHASES) / 1e3
    log(f"[obs] fit_exact_gp untraced {plain_s:.3f} s, traced {traced_s:.3f} s "
        f"({traced_s / plain_s - 1:+.1%}); modes {modes0} / {modes1}; loss "
        f"traces bit for bit {res0.loss_trace == res1.loss_trace} (max rel "
        f"diff {loss_rel:.3e}); spans {sorted(names)}; phase self-times "
        f"{covered:.1f} ms of the {wall:.1f} ms wall; phase spans {phase_ms:.1f}"
        f" ms of the mll_step spans' {mll_ms:.1f} ms; memory {mem}")
    log(f"[obs] telemetry {json.dumps(list(res1.telemetry))}")

    # the share of a full-data training step (mll_step + optimizer_step)
    # spent in each phase, and measured vs modeled at 3350 GB/s
    step_ms = sum(sp.dur for sp in spans
                  if sp.name in ("mll_step", "optimizer_step")) / 1e3
    share = {}
    for name in PHASES + ("optimizer_step",):
        ms = sum(sp.dur for sp in spans if sp.name == name) / 1e3
        share[name] = {"ms": ms, "share": ms / step_ms}
    share["mll_step (self)"] = {
        "ms": step_ms - sum(v["ms"] for v in share.values())}
    share["mll_step (self)"]["share"] = share["mll_step (self)"]["ms"] / step_ms
    cmp_rows = phase_model_comparison(events, hbm_gbps=3350.0)
    for r in cmp_rows:
        log(f"[obs] {r['backend']} {r['phase']}: {r['steps']} steps, measured "
            f"{r['measured_ms']:.2f} ms, modeled {r['modeled_gb']:.4f} GB = "
            f"{r['modeled_ms']:.3f} ms at 3350 GB/s, ratio {r['ratio']:.2f}, "
            f"modeled launches {r['modeled_launches']}")
    log(f"[obs] full-data steps {step_ms:.1f} ms: " + ", ".join(
        f"{k} {v['ms']:.1f} ms ({v['share']:.1%})" for k, v in share.items()))
    log("[obs] obs_report --compare-model --hbm-gbps 3350 --health:")
    obs_report.main([tpath, "--compare-model", "--hbm-gbps", "3350",
                     "--health", hpath])
    health_events = health.load_health(hpath)

    # one traced cold step at the trained parameters: the launches the card
    # made against the cost model's cg_solve launches, and the Eq. 2
    # backward's B5 launches and route (the other phases run plain PyTorch:
    # pivot rows, the SLQ eigensolves)
    engine = WarmStartEngine(gp.config.mll_config(), cfg.warm_config())
    gen = torch.Generator(device=DEV).manual_seed(1)
    obs.enable_tracing(None)
    torch.cuda.synchronize()
    kmvm.reset_launch_counts()
    kgrad.reset_launches()
    t1 = time.perf_counter()
    engine.step(X, y, res1.params, gen)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    step_counts = dict(kmvm.launch_counts)
    b5_launches = kgrad.launches
    obs.disable_tracing(snapshot_metrics=False)
    step_events = obs.drain_events()
    cg = [e for e in step_events if e.get("name") == "cg_solve"]
    modeled = cg[0]["args"]["modeled_launches"] if len(cg) == 1 else None
    b12 = step_counts["kmvm"] + step_counts["kmvm_dots"]
    routes = [e["args"].get("route") for e in step_events
              if e.get("name") == "eq2_backward"]
    log(f"[obs] cold step at the trained params: {engine.telemetry[-1]['mode']}"
        f", {step_s:.3f} s, cg_iters_per_rhs "
        f"{engine.telemetry[-1]['cg_iters_per_rhs']}, B1 + B2 launches "
        f"{step_counts} = {b12}, cg_solve modeled launches {modeled}, "
        f"B5 launches {b5_launches}, eq2_backward routes {routes}")
    gates = {
        "traced and untraced fits give the same modes": modes0 == modes1,
        "loss traces agree (bit for bit, else within 1e-6)":
            res0.loss_trace == res1.loss_trace or loss_rel <= 1e-6,
        "the span set": PHASE4C_SPANS <= names,
        "the phase spans cover the mll_step spans within 1%":
            mll_ms > 0 and abs(phase_ms - mll_ms) <= 0.01 * mll_ms,
        "cold step's B1 + B2 launches == cg_solve's modeled launches":
            modeled is not None and b12 == modeled,
        "cold step's Eq. 2 backward is one B5 launch on the fused route":
            b5_launches == 1 and routes == ["fused"],
        "memory snapshot of cuda0 > 0": mem.get("cuda0", 0) > 0,
        "no health event of severity error":
            not [e for e in health_events if e.get("severity") == "error"],
    }
    failed = [k for k, ok in gates.items() if not ok]
    shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise SystemExit(f"[obs] gates failed: {failed}")
    return {"plain_s": plain_s, "traced_s": traced_s, "loss_rel": loss_rel,
            "bitwise": res0.loss_trace == res1.loss_trace, "rows": cmp_rows,
            "share": share, "wall_ms": wall, "covered_ms": covered,
            "mll_ms": mll_ms, "phase_ms": phase_ms,
            "step_launches": step_counts, "modeled_launches": modeled,
            "b5_launches": b5_launches, "step_s": step_s,
            "health": [e["kind"] for e in health_events], "memory": mem}


def phase_spatial_observe(art, X_new, y_new, Xq) -> dict:
    """The spatial artifact in a one-model fleet absorbs 64 new field
    points: the plan is rebuilt over the extended inputs, the warm PCG runs
    on B4; the updated mean is held against a cold `fit_posterior` on the
    rebuilt plan. B4's count covers the update alone."""
    from repro_torch import obs
    from repro_torch.core.kernels_math import constant_mean
    from repro_torch.core.operators import make_operator
    from repro_torch.core.pcg import pcg
    from repro_torch.core.predcache import predict_mean
    from repro_torch.serve import FleetConfig, ServeFleet, fit_posterior
    from repro_torch.sparse import kmvm_sparse

    with ServeFleet(FleetConfig(capacity=1, chunk_size=1024), device=DEV) as fleet:
        fleet.register("spatial", art)
        fleet.digest("spatial")  # load and warm before the count
        torch.cuda.synchronize()
        kmvm_sparse.reset_launch_counts()
        iters0 = obs.counter("serve.fleet.update_cg_iters").value
        t0 = time.perf_counter()
        fleet.observe("spatial", X_new, y_new)
        torch.cuda.synchronize()
        update_s = time.perf_counter() - t0
        warm_iters = obs.counter("serve.fleet.update_cg_iters").value - iters0
        b4 = kmvm_sparse.launch_counts["kmvm_blocksparse"]
        new = fleet._ensure("spatial").artifact
        mean_u, var_u = fleet.predict("spatial", Xq, timeout=600)
    op = make_operator(new.config, new.X, new.params, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cold = fit_posterior(op, new.y,
                         generator=torch.Generator(device=DEV).manual_seed(9),
                         precond_rank=int(art.meta["precond_rank"]),
                         lanczos_rank=art.lanczos_rank,
                         pred_tol=float(art.meta["pred_tol"]))
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    Xq_d = torch.as_tensor(Xq, device=DEV)
    mean_c = predict_mean(op, Xq_d, cold.cache()).cpu().numpy()
    rel = float(np.max(np.abs(mean_u - mean_c)) / np.max(np.abs(mean_c)))
    # both posteriors against a tight solve of the same system
    yc = (new.y - constant_mean(op.params))[:, None]
    tight = pcg(op, yc, op.preconditioner(int(art.meta["precond_rank"])).solve,
                max_iters=2000, min_iters=10, tol=1e-4, track_residuals=True)
    # its iterates are the cold refit's until that stops: the refit's count
    below = (tight.residuals[10:, 0] <= float(art.meta["pred_tol"])).nonzero()
    cold_iters = 10 + int(below[0, 0])
    mean_t = (constant_mean(op.params)
              + op.cross_matvec(Xq_d, tight.solution[:, 0])).cpu().numpy()
    scale = np.max(np.abs(mean_t))
    res_u = float(new.meta["solve_rel_residual"])
    out = {"update_s": update_s, "refit_s": refit_s, "b4_launches": b4,
           "pairs_before": art.config.plan.num_pairs,
           "pairs_after": new.config.plan.num_pairs,
           "rel_residual": res_u, "mean_vs_refit": rel,
           "update_vs_tight": float(np.max(np.abs(mean_u - mean_t)) / scale),
           "refit_vs_tight": float(np.max(np.abs(mean_c - mean_t)) / scale),
           "tight_residual": float(tight.rel_residual.max()),
           "tight_iters": int(tight.iterations.max()),
           "rank": int(new.meta["lanczos_rank"]),
           "warm_iters": int(warm_iters), "cold_iters": cold_iters}
    log(f"[spatial] observe(64): update {update_s:.3f} s vs cold refit "
        f"{refit_s:.3f} s ({update_s / refit_s:.2%}); CG iterations warm "
        f"{warm_iters} vs cold {cold_iters}; plan pairs "
        f"{out['pairs_before']} -> {out['pairs_after']}; residual {res_u:.3e};"
        f" mean vs refit {rel:.3e}; against a solve to "
        f"{out['tight_residual']:.1e} ({out['tight_iters']} iterations): "
        f"update {out['update_vs_tight']:.3e}, refit "
        f"{out['refit_vs_tight']:.3e}; B4 launches during the update {b4}")
    if b4 <= 0:
        raise SystemExit("[spatial] B4 was never launched during observe")
    if not res_u <= float(art.meta["pred_tol"]):
        raise SystemExit(f"[spatial] update residual {res_u} > pred_tol")
    if not max(rel, out["update_vs_tight"]) <= 5e-2:
        raise SystemExit(f"[spatial] updated mean {rel:.3e} from the cold "
                         f"refit, {out['update_vs_tight']:.3e} from the tight "
                         f"solve (bound 5e-2)")
    if not (np.isfinite(var_u).all() and (var_u > 0).all()):
        raise SystemExit("[spatial] non-finite or non-positive variances")
    return out


def make_spatial_field(n: int, seed: int = 0):
    """The clustered 2-D sensor field of `examples/spatial_gp.py` (a numpy
    copy): 32 station clusters on the unit square, sigma 0.03, a smooth
    latent surface plus noise 0.1. Returns float32 (X, y, latent)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(size=(32, 2))
    X = centers[rng.integers(0, 32, n)] + 0.03 * rng.normal(size=(n, 2))
    latent = (np.sin(6.0 * X[:, 0]) * np.cos(4.0 * X[:, 1])
              + 0.5 * np.sin(9.0 * X[:, 0] * X[:, 1]))
    y = latent + 0.1 * rng.normal(size=n)
    return (X.astype(np.float32), y.astype(np.float32),
            latent.astype(np.float32))


# B4 cases: spec -> constrained support radius (None: not compact)
B4_SPECS = {"matern32 * wendland2": 0.15, "wendland4": 0.2,
            "rbf * wendland2 + matern32 * wendland4": 0.15, "matern32": None}
B4_TILES = ((8, 517), (32, 1000), (64, 2093), (256, 5001))  # (tile, n)


def _b4_problem(expr, radius, X, t, dtype, tile, seed):
    """(components, Xp, Vp, scalars, row_ptr, cols, plan) of one fused pass
    of `expr` over the plan of X, on the card."""
    from repro_torch.core.kernels_math import init_kernel_params
    from repro_torch.kernels.ops import fused_pass_or_none
    from repro_torch.sparse import build_plan
    from repro_torch.sparse.blocksparse import fused_operands

    params = init_kernel_params(expr, lengthscale=0.2, radius=radius,
                                noise=0.3, device=DEV)
    plan = build_plan(expr, X, params, tile=tile)
    ppass = fused_pass_or_none(expr, params)
    g = torch.Generator(device=DEV).manual_seed(seed)
    Xs = torch.as_tensor(X[plan.perm], device=DEV)
    V = torch.randn((X.shape[0], t), generator=g, device=DEV)
    Xp, Vp, scalars = fused_operands(ppass, Xs, V, dtype)
    return (ppass.components, Xp, Vp, scalars,
            torch.as_tensor(plan.row_ptr, device=DEV),
            torch.as_tensor(plan.pair_cols, device=DEV), plan)


def time_b4_spatial(X_spatial) -> tuple:
    """B4 at the spatial path's shape (2^18 Morton-sorted points, tile 256,
    the training plan at radius 0.15 + 10% margin, lengthscale 0.693), t = 1
    and 9, against its plain version, timed beside it and its two bounds:
    (rows, {t: max abs err})."""
    from repro_torch.core.kernels_math import init_kernel_params
    from repro_torch.kernels.ops import fused_pass_or_none
    from repro_torch.sparse import build_plan, kmvm_sparse
    from repro_torch.sparse.blocksparse import fused_operands

    params = init_kernel_params(SPATIAL_EXPR, noise=0.3, radius=0.15,
                                device=DEV)
    plan = build_plan(SPATIAL_EXPR, X_spatial, params, tile=256)
    ppass = fused_pass_or_none(SPATIAL_EXPR, params)
    n, d = X_spatial.shape
    Xs = torch.as_tensor(X_spatial[plan.perm], device=DEV)
    rp = torch.as_tensor(plan.row_ptr, device=DEV)
    cols = torch.as_tensor(plan.pair_cols, device=DEV)
    # the plan's longest-row-first schedule, as the operator launches it
    # (a tree that predates it launches in plan order)
    order = getattr(plan, "row_order", None)
    sched = {} if order is None else {
        "row_order": torch.as_tensor(order, device=DEV)}
    g = torch.Generator(device=DEV).manual_seed(11)
    entries = plan.entries
    counts = np.diff(plan.row_ptr)
    log(f"[blocksparse] main path plan: n={n} tile {plan.tile}, "
        f"{plan.num_tiles} tiles, {plan.num_pairs} pairs, fill {plan.fill:.4f}, "
        f"{entries:.4g} entries per MVM, pairs per row mean "
        f"{counts.mean():.1f} max {plan.kmax}")
    rows, abs_err = [], {}
    for t, reps in ((1, 5), (9, 3)):
        V = torch.randn((n, t), generator=g, device=DEV)
        Xp, Vp, sc = fused_operands(ppass, Xs, V)

        def kern():
            return kmvm_sparse.kmvm_blocksparse(ppass.components, Xp, Xp, Vp,
                                                sc, rp, cols, tile=plan.tile,
                                                **sched)

        def plain():
            return kmvm_sparse.kmvm_blocksparse_plain(
                ppass.components, Xp, Xp, Vp, sc, rp, cols, tile=plan.tile)

        out, ref = kern(), plain()
        torch.cuda.synchronize()
        err = _rel(out, ref)
        abs_err[t] = float(torch.max(torch.abs(out - ref)))
        if not err <= TOL[torch.float32]:
            raise SystemExit(f"[blocksparse] MISMATCH main path t={t}: {err:.2e}")
        ms = _time_ms(kern, reps)
        plain_ms = _time_ms(plain, 1)
        b = _bounds(
            ppass.components, n, n, d, t, 4, False, entries=entries,
            extra_bytes=4 * (plan.num_pairs + plan.num_tiles + 1) - n * d * 4)
        rows.append({"shape": [n, n, d, t], "entries": entries, "ms": ms,
                     "plain_ms": plain_ms, **b})
        log(f"[blocksparse] time B4 (n={n}, d={d}, t={t}, tile {plan.tile}): "
            f"{ms:.3f} ms (bound {b['bound_ms']:.3f} ms, "
            f"{b['bound_ms'] / ms:.1%} of it; tc bound {b['tc_bound_ms']:.3f} "
            f"ms), plain {plain_ms:.3f} ms; rel err {err:.2e} abs "
            f"{abs_err[t]:.2e}")
    return rows, abs_err


def phase_blocksparse(X_spatial) -> dict:
    from repro_torch.kernels import kmvm
    from repro_torch.sparse import kmvm_sparse

    def rel(a, b):
        return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))

    rng = np.random.default_rng(3)
    worst, cases = 0.0, 0
    for expr, radius in B4_SPECS.items():
        for tile, n in B4_TILES:
            X = rng.uniform(size=(n, 2)).astype(np.float32)
            for t in (1, 9, 128):
                for dtype in (torch.float32, torch.bfloat16):
                    comps, Xp, Vp, sc, rp, cols, plan = _b4_problem(
                        expr, radius, X, t, dtype, tile, cases)
                    out = kmvm_sparse.kmvm_blocksparse(comps, Xp, Xp, Vp, sc,
                                                       rp, cols, tile=plan.tile)
                    lrf = kmvm_sparse.kmvm_blocksparse(
                        comps, Xp, Xp, Vp, sc, rp, cols, tile=plan.tile,
                        row_order=torch.as_tensor(plan.row_order, device=DEV))
                    torch.cuda.synchronize()
                    if not torch.equal(out, lrf):
                        raise SystemExit(
                            f"[blocksparse] longest-row-first launch differs "
                            f"from plan order: {expr} tile {tile} n {n} t {t} "
                            f"{dtype}")
                    ref = kmvm_sparse.kmvm_blocksparse_plain(
                        comps, Xp, Xp, Vp, sc, rp, cols, tile=plan.tile)
                    err = rel(out, ref)
                    if radius is None:  # all-active: B4 is the dense product
                        err = max(err, rel(out, kmvm.kmvm_fused(
                            comps, Xp, Xp, Vp, sc)))
                    tol = TOL[dtype]
                    cases += 1
                    worst = max(worst, err / tol)
                    if not err <= tol:
                        raise SystemExit(
                            f"[blocksparse] MISMATCH {expr} tile {tile} n {n} "
                            f"t {t} {dtype}: {err:.2e} > {tol} (fill "
                            f"{plan.fill:.3f})")
    log(f"[blocksparse] {cases} cases match their plain versions (and B1 on "
        f"the all-active plans; longest-row-first = plan order bit for bit); "
        f"worst error / tolerance {worst:.3f}")

    rows, abs_err = time_b4_spatial(X_spatial)
    return {"rows": rows, "abs_err": abs_err, "worst": worst, "cases": cases}


def phase_spatial(X, y, Xte, lte) -> dict:
    """Train -> precompute -> artifact round trip -> engine check ->
    MicroBatcher traffic on the blocksparse backend; B4's launch counter
    covers exactly this path."""
    from repro_torch.core.gp import ExactGP, ExactGPConfig, rmse
    from repro_torch.core.kernels_math import init_kernel_params
    from repro_torch.kernels import kmvm
    from repro_torch.launch import serve_gp
    from repro_torch.serve import (
        PredictionEngine, fit_posterior, load_artifact, save_artifact)
    from repro_torch.sparse import kmvm_sparse, morton_order
    from repro_torch.train.gp_trainer import GPTrainConfig, fit_exact_gp

    n = X.shape[0]
    Xd = torch.as_tensor(X, device=DEV)
    yd = torch.as_tensor(y, device=DEV)
    params0 = init_kernel_params(SPATIAL_EXPR, noise=0.3, radius=0.15,
                                 device=DEV)
    gp = ExactGP(ExactGPConfig(kernel=SPATIAL_EXPR, precond_rank=50,
                               train_max_cg_iters=50, lanczos_rank=100,
                               backend="blocksparse"), device=DEV)
    art_dir = os.path.join(HERE, "build", "smoke_spatial_artifact")
    shutil.rmtree(art_dir, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kmvm.reset_launch_counts()
    kmvm_sparse.reset_launch_counts()
    t0 = time.perf_counter()

    res = fit_exact_gp(gp, Xd, yd, method="adam", params0=params0,
                       cfg=GPTrainConfig(plain_adam_steps=SPATIAL_STEPS, seed=0),
                       verbose=True, device=DEV)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_b4 = kmvm_sparse.launch_counts["kmvm_blocksparse"]
    steps = [{k: tm[k] for k in ("mode", "cg_iters", "cg_iters_per_rhs",
                                 "drift", "seconds")} for tm in res.telemetry]
    log(f"[spatial] trained {len(res.loss_trace)} steps in {train_s:.2f} s: "
        f"loss {[round(v, 5) for v in res.loss_trace]}, steps {steps}, "
        f"replans {res.replans}, B4 launches {train_b4}")
    if not all(np.isfinite(res.loss_trace)):
        raise SystemExit(f"[spatial] non-finite loss {res.loss_trace}")

    gen = torch.Generator(device=DEV).manual_seed(0)
    op = gp.operator(Xd, res.params)  # plans at the trained params
    plan = op.plan
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    art = fit_posterior(op, yd, generator=gen, precond_rank=50,
                        lanczos_rank=100, pred_tol=0.01, max_cg_iters=400)
    torch.cuda.synchronize()
    precompute_s = time.perf_counter() - t1
    fit_b4 = kmvm_sparse.launch_counts["kmvm_blocksparse"] - train_b4
    rel_res = art.meta["solve_rel_residual"]
    log(f"[spatial] posterior plan: {plan.num_pairs} pairs, fill "
        f"{plan.fill:.4f}, {plan.entries:.4g} entries, support "
        f"{plan.support:.4f}; precompute {precompute_s:.2f} s, rel residual "
        f"{rel_res:.3e}, B4 launches {fit_b4} (CG steps + 100 Lanczos)")
    if not rel_res <= 0.01:
        raise SystemExit(f"[spatial] mean solve residual {rel_res} > 0.01")

    save_artifact(art_dir, art)
    loaded = load_artifact(art_dir, device=DEV)  # rebuilds + checks the plan
    if loaded.config.plan.digest != plan.digest:
        raise SystemExit("[spatial] artifact plan digest changed on load")
    engine = PredictionEngine(loaded, chunk_size=1024, device=DEV)
    if not engine.sort_queries:
        raise SystemExit("[spatial] engine does not sort queries on a compact plan")
    engine.warmup()
    Xq = torch.as_tensor(Xte, device=DEV)
    verify = serve_gp.verify(engine, Xq[:512])
    if not verify <= 1e-5:
        raise SystemExit(f"[spatial] verification {verify} > 1e-5")
    mean, var = engine.predict(Xq)
    test_rmse = float(rmse(mean, torch.as_tensor(lte, device=DEV)))
    if not (torch.isfinite(mean).all() and (var > 0).all()):
        raise SystemExit("[spatial] non-finite or non-positive predictions")
    traffic = serve_gp.serve_traffic(engine, Xte, requests=200,
                                     points_per_request=8, clients=8)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = dict(kmvm_sparse.launch_counts)
    other = dict(kmvm.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    from_dir = from_dir_check("spatial", art_dir, Xq, mean, kmvm_sparse,
                              "kmvm_blocksparse")
    # after the count: one Morton-sorted 1024-row chunk of queries, the
    # engine's cross-covariance launch (64-row query tiles against 256-row
    # plan tiles, the query rows repeated per column segment) for the mean
    # (t = 1) and the variance, held against B4's plain version on the same
    # operands, then timed
    chunk = Xq[torch.as_tensor(morton_order(Xte), device=DEV)[:1024]]
    cross_ms, cross_err, cross_plain_ms, cross_bound = {}, {}, {}, {}
    for rhs in (engine.artifact.mean_cache, engine.artifact.var_Q):
        t = 1 if rhs.ndim == 1 else rhs.shape[1]
        args, kwargs = engine.op.cross_launch_operands(chunk, rhs)
        out = kmvm_sparse.kmvm_blocksparse(*args, **kwargs)
        torch.cuda.synchronize()
        ref = kmvm_sparse.kmvm_blocksparse_plain(*args, **kwargs)
        cross_err[t] = float(torch.max(torch.abs(out - ref))
                             / torch.max(torch.abs(ref)))
        cross_plain_ms[t] = _time_ms(
            lambda: kmvm_sparse.kmvm_blocksparse_plain(*args, **kwargs), 1)
        # the work the chunk's data needs: 1024 queries against the
        # columns of its active tiles (each query once, whatever the launch
        # repeats per column segment), plus the CSR it reads
        ncols = int(torch.unique(args[6]).numel()) * kwargs["tile"]
        cross_bound[t] = _bounds(
            args[0], chunk.shape[0], ncols, chunk.shape[1], t, 4, False,
            extra_bytes=4 * (args[5].numel() + args[6].numel()))
        if not cross_err[t] <= TOL[torch.float32]:
            raise SystemExit(f"[spatial] MISMATCH B4 serving launch t={t} "
                             f"(rows {args[1].shape[0]}, tile {kwargs['tile']}, "
                             f"row tile {kwargs['row_tile']}): "
                             f"{cross_err[t]:.2e} > {TOL[torch.float32]}")
        cross_ms[t] = _time_ms(lambda: engine.op.cross_matvec(chunk, rhs), 5)
    log(f"[spatial] engine vs unchunked {verify:.2e}; test rmse vs latent "
        f"{test_rmse:.4f}; p50 {traffic['p50_ms']:.2f} ms p99 "
        f"{traffic['p99_ms']:.2f} ms qps {traffic['qps']:.1f} over "
        f"{traffic['batches']} batches; peak memory {peak / 2**30:.2f} GiB; "
        f"path {total_s:.1f} s; launches {launches} (B1/B2 {other}); "
        f"cross_matvec of a sorted 1024-query chunk (t: ms) {cross_ms}, "
        f"its B4 launch vs plain (t: rel err) {cross_err}, plain (t: ms) "
        f"{cross_plain_ms}, bounds (t: ms) {cross_bound}")
    if launches["kmvm_blocksparse"] <= 0:
        raise SystemExit("[spatial] B4 was never launched on the main path")
    Xn, yn, _ = make_spatial_field(64, seed=DATA_SEED + 1)
    observed = phase_spatial_observe(loaded, Xn, yn, Xte[:512])
    return {"observe": observed, "train_s": train_s, "train_b4": train_b4, "loss": res.loss_trace,
            "steps": steps, "replans": [list(r) for r in res.replans],
            "fill": plan.fill, "pairs": plan.num_pairs,
            "entries": plan.entries, "precompute_s": precompute_s,
            "fit_b4": fit_b4, "rel_residual": rel_res, "verify": verify,
            "test_rmse": test_rmse, "peak_bytes": peak, "path_s": total_s,
            "launches": launches, "from_dir": from_dir, "cross_ms": cross_ms,
            "cross_err": cross_err, "cross_plain_ms": cross_plain_ms,
            "cross_bound": cross_bound, **traffic}


def phase_crosscheck(X, y) -> dict:
    """MLL value and Eq. 2 gradients: blocksparse (B4) against partitioned
    on the card, same probes and preconditioner."""
    from repro_torch.core.kernels_math import init_kernel_params, params_leaves
    from repro_torch.core.mll import (
        MLLConfig, operator_mll_backward, operator_mll_forward)
    from repro_torch.core.operators import make_operator

    Xd = torch.as_tensor(X, device=DEV)
    yd = torch.as_tensor(y, device=DEV)
    params = init_kernel_params(SPATIAL_EXPR, noise=0.3, radius=0.15,
                                device=DEV)
    out = {}
    precond = probes = None
    for backend in ("partitioned", "blocksparse"):
        cfg = MLLConfig(kernel=SPATIAL_EXPR, precond_rank=50, num_probes=8,
                        max_cg_iters=400, cg_tol=1e-6, backend=backend)
        op = make_operator(cfg.operator_config(), Xd, params, device=DEV)
        if precond is None:
            precond = op.preconditioner(50)
            probes = precond.sample(
                torch.Generator(device=DEV).manual_seed(5), 8)
        (value, aux), (_, u_y, U, pinv_z), _ = operator_mll_forward(
            op, yd, precond_rank=50, num_probes=8, max_cg_iters=400,
            min_cg_iters=3, cg_tol=1e-6, precond=precond, probes=probes)
        cfg = cfg._replace(plan=getattr(op, "plan", None))
        g_X, _, g_p = operator_mll_backward(cfg, Xd, params, u_y, U, pinv_z, 1.0)
        out[backend] = (float(value), [g.cpu() for g in params_leaves(g_p)],
                        g_X.cpu(), int(aux.cg_iterations.max()))
    (v0, gp0, gx0, it0), (v1, gp1, gx1, it1) = out["partitioned"], out["blocksparse"]
    dv = abs(v1 - v0)
    ok = dv < 3e-5 * max(1.0, abs(v0))
    # hyperparameter gradients: the conformance tolerance per leaf; the X
    # gradient (each entry a sum of large cancelling terms at this n)
    # relative to its largest entry
    worst = max(float(torch.max(torch.abs(a - b) / (5e-4 + 5e-3 * torch.abs(b))))
                for a, b in zip(gp1, gp0))
    worst = max(worst, float(torch.max(torch.abs(gx1 - gx0))
                             / (5e-3 * torch.max(torch.abs(gx0)))))
    log(f"[crosscheck] n={X.shape[0]}: MLL partitioned {v0:.6f} blocksparse "
        f"{v1:.6f} (|diff| {dv:.3e}, CG {it0}/{it1}); gradients worst "
        f"|diff| / tolerance = {worst:.3f} (params {[float(g) for g in gp1]})")
    if not (ok and worst <= 1.0):
        raise SystemExit("[crosscheck] blocksparse and partitioned disagree")
    return {"value_diff": dv, "grad_worst": worst}


def _chunk_walk(fn, components, Xi, Xj, V, scalars, sizes):
    acc = torch.zeros((Xi.shape[0], V.shape[1]), dtype=torch.float32,
                      device=Xi.device)
    j = 0
    for nc in sizes:
        fn(components, Xi, Xj[j:j + nc].contiguous(), V[j:j + nc].contiguous(),
           scalars, acc)
        j += nc
    return acc


def time_ring_step() -> tuple:
    """B3 at one ring step of eight cards at n = 2^20 (rows = chunk = 2^17,
    d = 9), t = 1 and 9, against its plain version, timed beside it and its
    bound: (rows, {t: max abs err})."""
    from repro_torch.kernels import kmvm

    n, d = RING_STEP, 9
    g = torch.Generator(device=DEV).manual_seed(13)
    Xi = (torch.randn((n, d), generator=g, device=DEV) / math.sqrt(d)).contiguous()
    Xj = (torch.randn((n, d), generator=g, device=DEV) / math.sqrt(d)).contiguous()
    scalars = torch.tensor([1.0, 1.0], dtype=torch.float32, device=DEV)
    components = (("matern32",),)
    rows, abs_err = [], {}
    for t, reps in ((1, 3), (9, 3)):
        V = torch.randn((n, t), generator=g, device=DEV)
        acc0 = torch.randn((n, t), generator=g, device=DEV)
        out = kmvm.kmvm_fused_chunk(components, Xi, Xj, V, scalars, acc0.clone())
        torch.cuda.synchronize()
        ref = kmvm.kmvm_chunk_plain(components, Xi, Xj, V, scalars, acc0.clone())
        err = _rel(out, ref)
        abs_err[t] = float(torch.max(torch.abs(out - ref)))
        if not err <= TOL[torch.float32]:
            raise SystemExit(f"[chunk] MISMATCH ring step t={t}: {err:.2e}")
        acc = acc0.clone()
        ms = _time_ms(lambda: kmvm.kmvm_fused_chunk(components, Xi, Xj, V,
                                                    scalars, acc), reps)
        plain_ms = _time_ms(lambda: kmvm.kmvm_chunk_plain(
            components, Xi, Xj, V, scalars, acc), 1)
        b = _bounds(components, n, n, d, t, 4, False, extra_bytes=n * t * 4)
        rows.append({"shape": [n, n, d, t], "ms": ms, "plain_ms": plain_ms, **b})
        log(f"[chunk] time B3 ring step ({n}, {n}, {d}, {t}): {ms:.3f} ms "
            f"(bound {b['bound_ms']:.3f} ms, {b['bound_ms'] / ms:.1%} of it; "
            f"tc bound {b['tc_bound_ms']:.3f} ms), plain {plain_ms:.3f} ms; "
            f"rel err {err:.2e} abs {abs_err[t]:.2e}")
    return rows, abs_err


def phase_chunk() -> dict:
    """B3 against its plain version and B1; then timed at a ring step."""
    from repro_torch.kernels import kmvm

    worst, cases = 0.0, 0
    for spec in ("matern32", "0.5*rbf + matern32"):
        components, scal = SPECS[spec]
        scalars = torch.tensor(scal, dtype=torch.float32, device=DEV)
        for m, sizes in ((100, (64, 64, 128)), (257, (4096, 1000)),
                         (33, (640, 77)), (4100, (4096, 4096))):
            for t in (1, 9, 128):
                for dtype in (torch.float32, torch.bfloat16):
                    Xi, Xj, V, _, _ = _case_inputs(m, sum(sizes), 9, t, dtype,
                                                   cases)
                    out = _chunk_walk(kmvm.kmvm_fused_chunk, components, Xi,
                                      Xj, V, scalars, sizes)
                    torch.cuda.synchronize()
                    ref = _chunk_walk(kmvm.kmvm_chunk_plain, components, Xi,
                                      Xj, V, scalars, sizes)
                    err = _rel(out, ref)
                    cases += 1
                    worst = max(worst, err / TOL[dtype])
                    if not err <= TOL[dtype]:
                        raise SystemExit(f"[chunk] MISMATCH {spec} m={m} "
                                         f"{sizes} t={t} {dtype}: {err:.2e}")
    components, scal = SPECS["matern32"]
    scalars = torch.tensor(scal, dtype=torch.float32, device=DEV)
    bitwise = []
    for t in (1, 9, 128):
        for dtype in (torch.float32, torch.bfloat16):
            Xi, Xj, V, _, _ = _case_inputs(300, 4096, 9, t, dtype, 50 + t)
            full = kmvm.kmvm_fused(components, Xi, Xj, V, scalars)
            one = _chunk_walk(kmvm.kmvm_fused_chunk, components, Xi, Xj, V,
                              scalars, (4096,))
            walk = _chunk_walk(kmvm.kmvm_fused_chunk, components, Xi, Xj, V,
                               scalars, (64, 1024, 2048, 960))
            torch.cuda.synchronize()
            same = torch.equal(one, full) and (
                torch.equal(walk, full) if t > 1 else _rel(walk, full) <= TOL[dtype])
            if not same:
                raise SystemExit(f"[chunk] walk != one B1 launch at t={t} {dtype}")
            bitwise.append((t, str(dtype).split(".")[-1]))
    log(f"[chunk] {cases} walks match their plain versions (worst error / "
        f"tolerance {worst:.3f}); chunk walks equal one B1 launch at n = 4096 "
        f"for {bitwise}")

    rows, abs_err = time_ring_step()
    return {"rows": rows, "abs_err": abs_err, "worst": worst, "cases": cases}


def _dist_engine_rmse(art, X_test, y_test) -> tuple:
    """(test rmse, engine-vs-unchunked error) of an artifact served through
    a chunk-1024 engine."""
    from repro_torch.core.gp import rmse
    from repro_torch.launch import serve_gp
    from repro_torch.serve import PredictionEngine

    engine = PredictionEngine(art, chunk_size=1024, device=DEV)
    engine.warmup()
    Xq = torch.as_tensor(X_test, dtype=torch.float32, device=DEV)
    check = serve_gp.verify(engine, Xq[:512])
    mean, var = engine.predict(Xq)
    if not (torch.isfinite(mean).all() and (var > 0).all()):
        raise SystemExit("[dist] non-finite or non-positive predictions")
    yq = torch.as_tensor(y_test, dtype=torch.float32, device=DEV)
    return float(rmse(mean, yq)), check


def phase_distributed() -> dict:
    """The gp-exact-1m launcher on a one-rank NCCL group, then the mesh's
    mean-cache solve, `posterior_from_mean_cache`, save, load and serve;
    B3's launch counter covers the phase."""
    import torch.distributed as dist

    from repro_torch.core.distributed import ShardedOperator, make_mean_cache_solve
    from repro_torch.core.operators import OperatorConfig, make_operator
    from repro_torch.kernels import kmvm
    from repro_torch.launch import obs_report, train
    from repro_torch.obs.measure import collective_microbench
    from repro_torch.obs.report import load_trace
    from repro_torch.serve import (
        load_artifact, posterior_from_mean_cache, save_artifact)

    store_dir = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    if DEV == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if DEV == "cuda" else "gloo",
                            init_method=f"file://{store_dir}/store",
                            rank=0, world_size=1)
    single_dir = os.path.join(HERE, "build", "smoke_dist_single")
    dist_dir = os.path.join(HERE, "build", "smoke_dist_artifact")
    for dname in (single_dir, dist_dir):
        shutil.rmtree(dname, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trace_path = os.path.join(store_dir, "dist.jsonl")
    kmvm.reset_launch_counts()
    t0 = time.perf_counter()
    report = train.main([
        "--arch", "gp-exact-1m", "--gp-n", str(DIST_GP_N), "--gp-backend",
        "pallas", "--gp-mode", "2d", "--gp-overlap", "--steps", str(DIST_STEPS),
        "--save-artifact", single_dir, "--device", DEV,
        "--obs-trace", trace_path])
    torch.cuda.synchronize()
    launch_s = time.perf_counter() - t0
    train_counts = dict(kmvm.launch_counts)
    steps = [{k: tm[k] for k in ("mode", "cg_iters", "cg_iters_per_rhs",
                                 "seconds")} for tm in report["telemetry"]]
    log(f"[dist] launcher (train {DIST_STEPS} steps + single-device "
        f"fit_posterior) {launch_s:.2f} s: n={report['n']}, nll/n "
        f"{[round(v, 5) for v in report['losses']]}, steps {steps}, launches "
        f"{train_counts}; single-device residual "
        f"{report['artifact_rel_residual']:.3e}")
    if not all(np.isfinite(report["losses"])):
        raise SystemExit(f"[dist] non-finite loss {report['losses']}")
    trace_events, _ = load_trace(trace_path)
    mll_spans = [e for e in trace_events if e.get("name") == "mll_step"]
    log(f"[dist] --obs-trace: {len(trace_events)} events, {len(mll_spans)} "
        f"mll_step spans; obs_report:")
    obs_report.main([trace_path])
    if len(mll_spans) != DIST_STEPS:
        raise SystemExit(f"[dist] the trace holds {len(mll_spans)} mll_step "
                         f"spans for {DIST_STEPS} steps")

    mesh, geom, cfg = report["mesh"], report["geom"], report["cfg"]
    params, X, y_loc = report["params"], report["X"], report["y_local"]
    n = report["n"]
    before = kmvm.launch_counts["kmvm_chunk"]
    t1 = time.perf_counter()
    a, rel = make_mean_cache_solve(mesh, geom, cfg, tol=0.01, max_iters=400)(
        X, y_loc, params)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t1
    solve_iters = kmvm.launch_counts["kmvm_chunk"] - before
    rel = float(rel.max())
    t2 = time.perf_counter()
    op = make_operator(OperatorConfig(kernel=cfg.kernel, backend="pallas"),
                       X[:n], params, device=DEV)
    art = posterior_from_mean_cache(
        op, a, generator=torch.Generator(device=DEV).manual_seed(0),
        y=report["y"][:n], solve_rel_residual=rel)
    torch.cuda.synchronize()
    lanczos_s = time.perf_counter() - t2
    save_artifact(dist_dir, art)
    s = report["data"]
    rmse_dist, check_dist = _dist_engine_rmse(load_artifact(dist_dir, device=DEV),
                                              s.X_test, s.y_test)
    rmse_single, check_single = _dist_engine_rmse(
        load_artifact(single_dir, device=DEV), s.X_test, s.y_test)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = dict(kmvm.launch_counts)
    peak = torch.cuda.max_memory_allocated()

    # after the count: one MVM with the ring overlap on and off
    V = torch.randn((geom.n_local, 9), device=DEV,
                    generator=torch.Generator(device=DEV).manual_seed(3))
    outs = [ShardedOperator(cfg.operator_config(geom._replace(overlap=ov)), X,
                            params).matvec(V) for ov in (True, False)]
    torch.cuda.synchronize()
    same = torch.equal(outs[0], outs[1])
    diff = abs(rmse_dist - rmse_single) / rmse_single
    collectives = collective_microbench(mesh, geom)
    log(f"[dist] collective_microbench on the one-rank group: {collectives}")
    if collectives != []:
        raise SystemExit(f"[dist] one rank has no collective to time, got "
                         f"{collectives}")
    log(f"[dist] mean-cache solve {solve_s:.2f} s, {solve_iters} CG "
        f"iterations (B3 launches), residual {rel:.3e}; posterior Lanczos "
        f"{lanczos_s:.2f} s; engine vs unchunked {check_dist:.2e} / "
        f"{check_single:.2e}; test rmse mesh route {rmse_dist:.5f}, "
        f"single-device route {rmse_single:.5f} (rel diff {diff:.2e}); overlap "
        f"on/off bitwise {same}; peak memory {peak / 2**30:.2f} GiB; path "
        f"{path_s:.1f} s; launches {launches}")
    if not rel <= 0.01:
        raise SystemExit(f"[dist] mean-cache residual {rel} > 0.01")
    if not (check_dist <= 1e-5 and check_single <= 1e-5):
        raise SystemExit(f"[dist] engine verification {check_dist}, {check_single}")
    if not diff <= 0.02:
        raise SystemExit(f"[dist] test rmse differ by {diff:.3e} > 2%")
    if not same:
        raise SystemExit("[dist] overlap on and off differ")
    if launches["kmvm_chunk"] <= 0:
        raise SystemExit("[dist] B3 was never launched on the main path")
    return {"report": report, "train_counts": train_counts, "steps": steps,
            "launch_s": launch_s, "solve_s": solve_s, "solve_iters": solve_iters,
            "rel_residual": rel, "lanczos_s": lanczos_s, "rmse_dist": rmse_dist,
            "rmse_single": rmse_single, "launches": launches, "peak_bytes": peak,
            "path_s": path_s, "store_dir": store_dir}


def phase_dist_crosscheck(X, y) -> dict:
    """MLL value and Eq. 2 gradients: the sharded operator on the
    blocksparse inner backend (B4 per ring chunk) against the single-device
    blocksparse operator, same probes and preconditioner."""
    from repro_torch.core import distributed as D
    from repro_torch.core.kernels_math import init_kernel_params, params_leaves
    from repro_torch.core.mll import (
        MLLConfig, operator_mll_backward, operator_mll_forward)
    from repro_torch.core.operators import make_operator
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sparse import build_plan, kmvm_sparse, morton_order

    perm = morton_order(X)
    Xd = torch.as_tensor(X[perm], device=DEV)
    yd = torch.as_tensor(y[perm], device=DEV)
    n = Xd.shape[0]
    params = init_kernel_params(SPATIAL_EXPR, noise=0.3, radius=0.15, device=DEV)
    kw = dict(precond_rank=50, num_probes=8, max_cg_iters=400, min_cg_iters=3,
              cg_tol=1e-6)
    cfg = MLLConfig(kernel=SPATIAL_EXPR, backend="blocksparse",
                    **{k: kw[k] for k in ("precond_rank", "num_probes",
                                          "max_cg_iters", "cg_tol")})
    op = make_operator(cfg.operator_config(), Xd, params, device=DEV)
    precond = op.preconditioner(50)
    probes = precond.sample(torch.Generator(device=DEV).manual_seed(5), 8)
    (v0, _), (_, u_y, U, pinv_z), _ = operator_mll_forward(
        op, yd, precond=precond, probes=probes, **kw)
    _, _, g0 = operator_mll_backward(cfg._replace(plan=op.plan), Xd, params,
                                     u_y, U, pinv_z, -1.0 / n)

    mesh = make_host_mesh(device=DEV)
    geom = D.make_geometry(mesh, n, 2, mode="2d", tile_multiple=256)
    plan = build_plan(SPATIAL_EXPR, Xd, params, tile=256, assume_sorted=True)
    dcfg = D.DistMLLConfig(kernel=SPATIAL_EXPR, backend="blocksparse", plan=plan,
                           precond_rank=50, num_probes=8, max_cg_iters=400,
                           cg_tol=1e-6)
    pre = D.DistPreconditioner(precond.L, precond.sigma2, precond.chol_inner, n)
    kmvm_sparse.reset_launch_counts()
    loss, aux, g1 = D.make_mll_value_and_grad(mesh, geom, dcfg)(
        Xd, yd, params, None, precond=pre, probes=probes)
    torch.cuda.synchronize()
    b4 = kmvm_sparse.launch_counts["kmvm_blocksparse"]
    v1 = -float(loss) * n
    dv = abs(v1 - float(v0))
    worst = max(float(torch.max(torch.abs(a - b) / (5e-4 + 5e-3 * torch.abs(b))))
                for a, b in zip(params_leaves(g1), params_leaves(g0)))
    log(f"[dist-crosscheck] n={n}: MLL single-device blocksparse {float(v0):.6f} "
        f"sharded blocksparse {v1:.6f} (|diff| {dv:.3e}, CG "
        f"{int(aux[2].max())}); gradients worst |diff| / tolerance "
        f"{worst:.3f}; B4 launches {b4}")
    if not (dv < 3e-5 * max(1.0, abs(float(v0))) and worst <= 1.0 and b4 > 0):
        raise SystemExit("[dist-crosscheck] sharded and single-device "
                         "blocksparse disagree")
    return {"value_diff": dv, "grad_worst": worst, "b4_launches": b4}


def _kmvm_fp64(components, scalars, X, V):
    """K(X, X) @ V in fp64, d2 as squared differences (no cancellation)."""
    from repro_torch.kernels import kmvm

    x = X.to(torch.float64)
    d2 = torch.cdist(x, x, compute_mode="donot_use_mm_for_euclid_dist").square()
    return (kmvm._epilogue(components, scalars.to(torch.float64), d2)
            @ V.to(torch.float64)).to(torch.float32)


def phase_dkl() -> dict:
    """Phase 11: deep kernel learning over smollm-360m at full width on the
    `pallas` backend (see the module docstring)."""
    from repro_torch.core.dkl import DKLModel, pooled_features
    from repro_torch.core.gp import ExactGP, ExactGPConfig, rmse
    from repro_torch.core.kernels_math import (
        init_params as gp_init_params,
        inv_softplus,
        params_leaves,
        params_map,
        softplus,
    )
    from repro_torch.kernels import kmvm
    from repro_torch.kernels.ops import fused_pass_or_none
    from repro_torch.models import LM, count_params, get_arch, init_params

    t_phase = time.perf_counter()
    cfg = get_arch(DKL_ARCH)
    lm = init_params(cfg, torch.Generator(device=DEV).manual_seed(DATA_SEED),
                     dtype=torch.float32, device=DEV)
    rng = np.random.default_rng(DATA_SEED)
    tokens = rng.integers(0, cfg.vocab, size=(DKL_N + DKL_TEST, DKL_SEQ))
    y = torch.as_tensor(np.sin(tokens[:, ::4].mean(1) / 8.0)
                        + 0.05 * rng.normal(size=len(tokens)),
                        dtype=torch.float32, device=DEV)
    tokens = torch.as_tensor(tokens, device=DEV)
    tok_tr, y_tr, y_te = tokens[:DKL_N], y[:DKL_N], y[DKL_N:]
    gp = ExactGP(ExactGPConfig(kernel="matern32", backend="pallas",
                               precond_rank=20, train_max_cg_iters=30),
                 device=DEV)
    phi = functools.partial(pooled_features, cfg, device=DEV)
    # the lengthscale from the median pairwise distance of the initial
    # features: at the default (0.693) median d2 / l^2 is about 1e3, K is
    # the identity to e^-57, and neither the head nor the gradient into the
    # backbone sees the features (ROADMAP C3)
    with torch.no_grad():
        ell = float(torch.pdist(phi(lm, tok_tr)).median())
    p0 = gp.init_params(cfg.d_model, noise=0.2)
    gp_params = params_map(lambda a: a.requires_grad_(), p0._replace(
        raw_lengthscale=torch.full_like(p0.raw_lengthscale, inv_softplus(ell))))
    model = DKLModel(gp, phi)
    embed0 = lm.embed.detach().clone()
    wo0 = lm.blocks[-1].mlp["wo"].detach().clone()
    opt = torch.optim.Adam(list(lm.parameters()) + params_leaves(gp_params),
                           lr=DKL_LR)
    log(f"[dkl] {cfg.name}: {count_params(cfg, lm)} parameters ({cfg.n_layers} "
        f"layers, d {cfg.d_model}, {cfg.n_heads} heads on {cfg.n_kv_heads} KV, "
        f"ff {cfg.d_ff}, vocab {cfg.vocab}), fp32; {DKL_N} training and "
        f"{DKL_TEST} held-out sequences of {DKL_SEQ} tokens; target std "
        f"{float(torch.std(y_tr, correction=0)):.4f}; lengthscale {ell:.6g} "
        f"(median pairwise distance of the initial features)")

    # the main path: counts set to 0 just before, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kmvm.reset_launch_counts()
    losses, step_s = [], []
    for step in range(DKL_STEPS):
        t = time.perf_counter()
        opt.zero_grad()
        loss, aux = model.loss(tok_tr, y_tr, lm, gp_params,
                               torch.Generator(device=DEV).manual_seed(step))
        loss.backward()
        if step == 0:
            g_embed = float(torch.max(torch.abs(lm.embed.grad)))
        opt.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(float(loss.detach()))
        log(f"[dkl] step {step}: loss {losses[-1]:.6f} in {step_s[-1]:.2f} s "
            f"(CG {int(aux.cg_iterations.max())} iterations, residual "
            f"{float(aux.rel_residual.max()):.3e})")
    train_launches = dict(kmvm.launch_counts)
    with torch.no_grad():
        t = time.perf_counter()
        cache = model.precompute(
            tok_tr, y_tr, lm, gp_params,
            generator=torch.Generator(device=DEV).manual_seed(99))
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t
        t = time.perf_counter()
        # train and held-out rows in one call: the train features once as
        # the data, then all rows as queries
        mean, var = model.predict(tok_tr, tokens, lm, gp_params, cache)
        torch.cuda.synchronize()
        pred_s = time.perf_counter() - t
    launches = dict(kmvm.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    rmse_tr = float(rmse(mean[:DKL_N], y_tr))
    rmse_te = float(rmse(mean[DKL_N:], y_te))
    dembed = float(torch.max(torch.abs(lm.embed.detach() - embed0)))
    dlast = float(torch.max(torch.abs(lm.blocks[-1].mlp["wo"].detach() - wo0)))
    log(f"[dkl] {DKL_STEPS} steps {[round(v, 3) for v in step_s]} s, losses "
        f"{losses}; precompute {pre_s:.2f} s, predict ({len(tokens)} rows) "
        f"{pred_s:.2f} s; peak {peak / 2**30:.2f} GiB")
    log(f"[dkl] launches in training: B1 {train_launches['kmvm']}, B2 "
        f"{train_launches['kmvm_dots']}; on the whole path: B1 "
        f"{launches['kmvm']}, B2 {launches['kmvm_dots']}")
    log(f"[dkl] max |change|: embedding {dembed:.3e}, last block's MLP out "
        f"{dlast:.3e}; step 0's max |grad| of the embedding {g_embed:.3e}; "
        f"train RMSE {rmse_tr:.5f}, test RMSE {rmse_te:.5f}; lengthscale "
        f"{float(softplus(gp_params.raw_lengthscale.detach())):.6g} after training")
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"[dkl] non-finite loss: {losses}")
    # Adam moves an entry by about lr where |grad| >> its eps (1e-8) and by
    # lr |grad| / eps below: a move of lr / 2 says the gradient through g_X
    # cleared eps, where K = I left it at e^-57 and the move at 5e-12
    if not dembed >= DKL_LR / 2:
        raise SystemExit(f"[dkl] the embedding moved {dembed:.3e} < lr / 2 = "
                         f"{DKL_LR / 2:.1e}: no gradient reached the backbone")
    if not (mean.shape == (len(tokens),) and bool(torch.isfinite(mean).all())
            and bool(torch.isfinite(var).all()) and bool((var > 0).all())):
        raise SystemExit("[dkl] predictions not finite or variances <= 0")

    with torch.no_grad():
        # the same backbone on the CPU, on 4 held-out sequences
        lm_cpu = LM(cfg, dtype=torch.float32, device="meta").to_empty(device="cpu")
        lm_cpu.load_state_dict(lm.state_dict())
        probe = tokens[DKL_N:DKL_N + 4]
        f_err = _rel(phi(lm, probe).cpu(),
                     pooled_features(cfg, lm_cpu, probe.cpu(), device="cpu"))
        del lm_cpu
        log(f"[dkl] pooled features, card vs CPU (4 sequences): rel {f_err:.2e}")
        if not f_err <= TOL[torch.float32]:
            raise SystemExit(f"[dkl] card and CPU features differ: {f_err:.2e}")
        feats = phi(lm, tok_tr)
    fit_params = params_map(lambda a: a.detach(), gp_params)
    ppass = fused_pass_or_none(gp.config.kernel, fit_params)
    components = ppass.components
    Xs = (feats / ppass.lengthscale).contiguous()  # as the operator passes them
    scalars = torch.stack([torch.as_tensor(v, device=DEV).to(torch.float32)
                           for v in ppass.scalars])
    n, d = Xs.shape
    log(f"[dkl] scaled features: max |x|^2 {float(Xs.square().sum(1).max()):.4g}, "
        f"median d2 {float(torch.cdist(Xs[:256], Xs[:256]).square().median()):.4g}")
    g = torch.Generator(device=DEV).manual_seed(11)
    abs_err, rows = {}, {"kmvm": [], "kmvm_dots": []}
    for t in (1, 9):
        V = torch.randn((n, t), generator=g, device=DEV)
        R = torch.randn((n, t), generator=g, device=DEV)
        # K must be far from the identity, or the comparison below could
        # not see a wrong cross term or feature walk: the off-diagonal part
        # of K @ V at least 10x the tolerance
        ref = kmvm.kmvm_plain(components, Xs, Xs, V, scalars)
        k0 = kmvm._epilogue(components, scalars, torch.zeros((1, 1), device=DEV))
        off = float(torch.max(torch.abs(ref - k0 * V)) / torch.max(torch.abs(ref)))
        # against an fp64 evaluation (d2 summed as squared differences):
        # printed, not gated
        exact = _kmvm_fp64(components, scalars, Xs, V)
        log(f"[dkl] t {t}: off-diagonal part of K @ V {off:.3e} of max|out|; "
            f"against fp64: B1 "
            f"{_rel(kmvm.kmvm_fused(components, Xs, Xs, V, scalars), exact):.2e}, "
            f"plain {_rel(ref, exact):.2e}")
        if not off >= 10 * TOL[torch.float32]:
            raise SystemExit(f"[dkl] K is near the identity at t {t}: "
                             f"off-diagonal part {off:.3e} of max|out|")
        e1, e2, a1, a2 = _compare(kmvm, components, scalars, Xs, Xs, V, V, R)
        log(f"[dkl] kernels at the trained features ({n}, {n}, d {d}, t {t}): "
            f"B1 rel {e1:.2e} abs {a1:.2e}, B2 rel {e2:.2e} abs {a2:.2e}")
        if not (e1 <= TOL[torch.float32] and e2 <= TOL[torch.float32]):
            raise SystemExit(f"[dkl] MISMATCH at d {d}, t {t}: B1 {e1:.2e} "
                             f"B2 {e2:.2e} > {TOL[torch.float32]}")
        abs_err[t] = (a1, a2)
        rows["kmvm"].append(_time_row(
            "kmvm", (n, n, d, t), components,
            lambda: kmvm.kmvm_fused(components, Xs, Xs, V, scalars),
            lambda: kmvm.kmvm_plain(components, Xs, Xs, V, scalars), 20, 5))
        rows["kmvm_dots"].append(_time_row(
            "kmvm_dots", (n, n, d, t), components,
            lambda: kmvm.kmvm_fused_dots(components, Xs, Xs, V, V, R, scalars)[0],
            lambda: kmvm.kmvm_dots_plain(components, Xs, Xs, V, V, R, scalars)[0],
            20, 5))
    # ROADMAP C3, printed, not gated: the same features at the default
    # lengthscale, where K is the identity and the expansion's rounding of
    # d2(x, x) (of order eps |x|^2 / l^2) is all that is left of K
    p_def = fused_pass_or_none(gp.config.kernel, gp_init_params(device=DEV))
    Xd = (feats / p_def.lengthscale).contiguous()
    sc_def = torch.stack([torch.as_tensor(v, device=DEV).to(torch.float32)
                          for v in p_def.scalars])
    V = torch.randn((n, 1), generator=g, device=DEV)
    exact = _kmvm_fp64(p_def.components, sc_def, Xd, V)
    b1 = kmvm.kmvm_fused(p_def.components, Xd, Xd, V, sc_def)
    plain = kmvm.kmvm_plain(p_def.components, Xd, Xd, V, sc_def)
    log(f"[dkl] C3, at the default lengthscale {float(p_def.lengthscale):.4g} (max |x|^2 / l^2 "
        f"{float(Xd.square().sum(1).max()):.4g}), t 1: B1 vs plain "
        f"{_rel(b1, plain):.2e}, B1 vs fp64 {_rel(b1, exact):.2e}, plain vs "
        f"fp64 {_rel(plain, exact):.2e}")
    if not (launches["kmvm"] > 0 and launches["kmvm_dots"] > 0):
        raise SystemExit(f"[dkl] B1/B2 not launched on the path: {launches}")
    log(f"[dkl] phase 11 in {time.perf_counter() - t_phase:.1f} s on "
        f"{card_and_power_limit()}")
    return {"launches": launches, "train_launches": train_launches,
            "abs_err": abs_err, "rows": rows, "step_s": step_s,
            "losses": losses, "precompute_s": pre_s, "predict_s": pred_s,
            "peak_bytes": peak, "rmse": (rmse_tr, rmse_te)}


def _record_routes(lm, fn):
    """Run fn() under forward hooks on every MoE layer: fn's result and, per
    layer, over all of the layer's calls in order (concatenated along S):
    the experts (sorted) each token chose (B, S, k), its top-k margin, the
    k-th less the (k + 1)-th router probability (B, S), and whether each
    (token, k) pair kept a slot (B, S * k)."""
    from repro_torch.models.moe import moe_route

    rec = [[] for _ in lm.blocks]

    def hook_for(i):
        def hook(mod, args, kwargs, out):
            k = kwargs["top_k"]
            probs, _, top_i, _, _, keep, _ = moe_route(
                mod, args[0], top_k=k, capacity_factor=kwargs["capacity_factor"])
            srt = torch.sort(probs, -1, descending=True).values
            rec[i].append((torch.sort(top_i, -1).values,
                           srt[..., k - 1] - srt[..., k], keep))
        return hook

    handles = [blk.moe.register_forward_hook(hook_for(i), with_kwargs=True)
               for i, blk in enumerate(lm.blocks)]
    try:
        out = fn()
    finally:
        for h in handles:
            h.remove()
    return out, [tuple(torch.cat(parts, 1) for parts in zip(*calls))
                 for calls in rec]


def _drops(routes) -> tuple:
    """(dropped, all) (token, k) pairs over the layers' `_record_routes`."""
    return (sum(int((~keep).sum()) for _, _, keep in routes),
            sum(keep.numel() for _, _, keep in routes))


def _decode_vs_forward(cfg, lm, batch, chk):
    """Per sequence and step, prefill's and the first SERVE_CHECK_STEPS
    decode steps' logits in `chk` (a `generate` result) against the full
    forward's at the same positions over the same tokens, relative to that
    sequence's max|logit| there: (B, steps + 1)."""
    from repro_torch.models import forward_hidden

    p = batch["tokens"].shape[1]
    steps = chk["tokens"][:, :SERVE_CHECK_STEPS]     # their input tokens
    full = dict(batch, tokens=torch.cat([batch["tokens"], steps], 1))
    if "embeds" in batch:
        pad = torch.zeros_like(batch["embeds"][:, :SERVE_CHECK_STEPS])
        full["embeds"] = torch.cat([batch["embeds"], pad], 1)
        full["embed_mask"] = torch.cat(
            [batch["embed_mask"], torch.zeros_like(steps, dtype=torch.bool)], 1)
    with torch.no_grad():
        h, _ = forward_hidden(cfg, lm, full)
        ref = h[:, p - 1:].to(torch.float32) @ lm.embed.to(torch.float32).T
    dec = chk["logits"][:, :SERVE_CHECK_STEPS + 1]
    return (torch.amax(torch.abs(dec - ref), -1) /
            torch.amax(torch.abs(ref), -1)).cpu()


def _moe_check(cfg, lm, batch, tag) -> list:
    """Gate (b) for an MoE config. The top-k choice is discontinuous: a
    token whose k-th and (k + 1)-th router probabilities lie within fp32
    rounding of each other may route differently in the full forward than
    in prefill / decode (other matmul shapes, other rounding), and the
    difference then spreads through attention to the later tokens of its
    sequence (routing is per sequence, so no further). So: (1) at its own
    top-k, where nothing drops (capacity factor E / k: a slot for every
    token), every sequence whose tokens all routed alike in both runs,
    every layer, must agree within the tolerance, and a sequence that
    routed differently must have done so first at a margin below 1e-4
    (a near-tie, not a fault); (2) with every expert active (top-k = E,
    capacity factor 1: routing continuous), every sequence must agree."""
    from repro_torch.launch import serve

    nb, p = batch["tokens"].shape
    n = p + SERVE_CHECK_STEPS
    chk_cfg = cfg._replace(capacity_factor=cfg.n_experts / cfg.top_k)
    chk, dec_routes = _record_routes(
        lm, lambda: serve.generate(chk_cfg, lm, batch, SERVE_CHECK_STEPS + 1))
    errs, full_routes = _record_routes(
        lm, lambda: _decode_vs_forward(chk_cfg, lm, batch, chk))
    flips = torch.zeros((nb,), dtype=torch.bool)
    for layer, ((di, dm, _), (fi, fm, _)) in enumerate(zip(dec_routes,
                                                           full_routes)):
        diff = (di[:, :n] != fi[:, :n]).any(-1).cpu()       # (B, n)
        for b in torch.nonzero(diff.any(-1) & ~flips).flatten().tolist():
            s0 = int(torch.nonzero(diff[b])[0])
            margin = float(torch.minimum(dm[b, s0], fm[b, s0]))
            log(f"{tag}: sequence {b} first routes differently at layer {layer}, "
                f"token {s0}, top-{cfg.top_k} margin {margin:.3e}")
            if not margin <= 1e-4:
                raise SystemExit(f"{tag}: routing differs at margin {margin:.3e}")
            flips[b] = True
    drops = _drops(full_routes)
    log(f"{tag}: at top-{cfg.top_k}, capacity factor {chk_cfg.capacity_factor}: "
        f"{drops[0]} of {drops[1]} pairs dropped; {int(flips.sum())} of {nb} "
        f"sequences routed differently; decode steps 1-{SERVE_CHECK_STEPS} vs "
        f"the full forward per sequence: "
        f"{[[round(float(e), 8) for e in row[1:]] for row in errs]}")
    clean = errs[~flips, 1:]
    if drops[0] or (clean.numel() and not float(clean.max()) <= SERVE_LOGIT_TOL):
        raise SystemExit(f"{tag}: decode differs from the full forward where "
                         f"routing agreed: {clean.tolist()}, drops {drops[0]}")
    dense_cfg = cfg._replace(top_k=cfg.n_experts, capacity_factor=1.0)
    chk = serve.generate(dense_cfg, lm, batch, SERVE_CHECK_STEPS + 1)
    errs_all = _decode_vs_forward(dense_cfg, lm, batch, chk)
    log(f"{tag}: every expert active (top-{cfg.n_experts}): decode vs the full "
        f"forward, worst sequence per step {errs_all.amax(0).tolist()}")
    return errs_all.amax(0).tolist()


def _serve_lm_one(arch, b, p, patches) -> dict:
    """One arch of phase 12: `launch.serve`'s main at full width, then
    gates (a)-(d) (see the module docstring)."""
    from repro_torch.launch import serve
    from repro_torch.models import LM, forward_hidden, init_params

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_arch = time.perf_counter()
    argv = ["--arch", arch, "--full", "--batch", str(b), "--prompt-len", str(p),
            "--gen", str(SERVE_GEN), "--device", DEV]
    if patches:
        argv += ["--patches", str(patches)]
    rep = serve.main(argv)
    cfg, lm, batch = rep["cfg"], rep["lm"], rep["batch"]
    # the launcher's run is the first call at this model's shapes; a second
    # run of the same path gives the warm times
    warm = serve.generate(cfg, lm, batch, SERVE_GEN)
    timed = {"params": rep["params"], "prefill_ms_first": rep["prefill_ms"],
             "tokens_per_s_first": rep["tokens_per_s"],
             "prefill_ms": warm["prefill_ms"], "tokens_per_s": warm["tokens_per_s"],
             "step_ms_median": float(np.median(warm["step_ms"])),
             "step_ms_max": max(warm["step_ms"])}
    if not torch.equal(warm["tokens"], rep["tokens"]):
        raise SystemExit(f"[serve-lm] {arch}: a second run decoded other tokens")
    del warm
    tag = f"[serve-lm] {cfg.name}"
    # (a) every logit finite, prefill's and each decode step's
    if not bool(torch.isfinite(rep["logits"]).all()):
        raise SystemExit(f"{tag}: non-finite logits")
    # (c) the position after prefill and gen - 1 steps
    if rep["state"]["t"] != p + SERVE_GEN - 1:
        raise SystemExit(f"{tag}: t {rep['state']['t']} != {p + SERVE_GEN - 1}")
    # (b) decode steps 1..4 against the full forward over the same tokens
    drops = None
    if cfg.family == "moe":
        with torch.no_grad():
            drops = _drops(_record_routes(
                lm, lambda: forward_hidden(cfg, lm, batch))[1])
        log(f"{tag}: prefill at capacity factor {cfg.capacity_factor} drops "
            f"{drops[0]} of {drops[1]} (token, k) pairs over {cfg.n_layers} layers")
        del rep["state"]
        errs = _moe_check(cfg, lm, batch, tag)
    else:
        errs = _decode_vs_forward(cfg, lm, batch, rep).amax(0).tolist()
    log(f"{tag}: logits vs the full forward (rel to max|logit|): prefill "
        f"{errs[0]:.2e}, decode steps 1-{SERVE_CHECK_STEPS} "
        f"{', '.join(f'{e:.2e}' for e in errs[1:])}")
    if not max(errs[1:]) <= SERVE_LOGIT_TOL:
        raise SystemExit(f"{tag}: decode differs from the full forward: "
                         f"{errs[1:]} > {SERVE_LOGIT_TOL}")
    peak = torch.cuda.max_memory_allocated()
    del rep, lm
    torch.cuda.empty_cache()
    # (d) the card against the CPU, same weights, published width, depth 2
    cfg2 = cfg._replace(n_layers=SERVE_CPU_LAYERS,
                        n_enc_layers=SERVE_CPU_LAYERS if cfg.is_encdec else 0)
    lm2 = init_params(cfg2, torch.Generator(device=DEV).manual_seed(1),
                      dtype=torch.float32, device=DEV)
    lm2_cpu = LM(cfg2, dtype=torch.float32, device="meta").to_empty(device="cpu")
    lm2_cpu.load_state_dict(lm2.state_dict())
    nb, ns = SERVE_CPU_SHAPE
    b2 = serve.make_batch(cfg2, nb, ns, patches=ns // 4 if patches else 0,
                          seed=2, device=DEV)
    with torch.no_grad():
        h_card = forward_hidden(cfg2, lm2, b2)[0].cpu()
        h_cpu = forward_hidden(cfg2, lm2_cpu,
                               {k: v.cpu() for k, v in b2.items()})[0]
    cpu_err = _rel(h_card, h_cpu)
    del lm2, lm2_cpu
    torch.cuda.empty_cache()
    log(f"{tag}: forward_hidden at depth {SERVE_CPU_LAYERS}, card vs CPU "
        f"({nb} x {ns} tokens): rel {cpu_err:.2e}")
    if not cpu_err <= TOL[torch.float32]:
        raise SystemExit(f"{tag}: card and CPU differ: {cpu_err:.2e}")
    return {"arch": arch, "family": cfg.family, **timed, "batch": b,
            "prompt": p, "gen": SERVE_GEN, "patches": patches,
            "peak_gib": peak / 2**30, "decode_errs": errs, "cpu_err": cpu_err,
            "moe_drops": drops, "seconds": time.perf_counter() - t_arch}


def phase_serve_lm() -> dict:
    """Phase 12: `launch.serve` for each family at its published width and
    depth (see the module docstring)."""
    from repro_torch.kernels import kmvm
    from repro_torch.sparse import kmvm_sparse

    t_phase = time.perf_counter()
    kmvm.reset_launch_counts()
    kmvm_sparse.reset_launch_counts()
    rows = [_serve_lm_one(*case) for case in SERVE_LM]
    launches = {**kmvm.launch_counts, **kmvm_sparse.launch_counts}
    card = card_and_power_limit()
    for r in rows:
        log(f"[serve-lm] {r['arch']} ({r['family']}, {r['params']} parameters, "
            f"fp32): batch {r['batch']} x prompt {r['prompt']}: prefill "
            f"{r['prefill_ms']:.1f} ms, decode {r['tokens_per_s']:.1f} tokens/s "
            f"(step {r['step_ms_median']:.2f} ms median, {r['step_ms_max']:.2f} "
            f"ms max); first call: prefill {r['prefill_ms_first']:.1f} ms, "
            f"decode {r['tokens_per_s_first']:.1f} tokens/s; peak {r['peak_gib']:.2f} GiB, {r['seconds']:.1f} s; {card}")
    log(f"[serve-lm] B1-B4 launches on the LM serving path: {launches}")
    seconds = time.perf_counter() - t_phase
    log(f"[serve-lm] phase 12 in {seconds:.1f} s on {card}")
    return {"rows": rows, "launches": launches, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 13: the dry run's counter on the card
# ---------------------------------------------------------------------------

COUNT_ARCH = "smollm-360m"       # phase 13: published width and depth, bf16
COUNT_SHAPE = (4, 1024)          # one train step: batch x seq
COUNT_GP_N = 1 << 15             # the GP predict cell, partitioned
COUNT_GP_ITERS = 20              # fixed CG trips
COUNT_MEM_TOL = 0.15             # counted peak vs max_memory_allocated
DRYRUN_ARCHS = "smollm-360m,gp-exact-1m"
# phase 14: (arch, batch, seq, steps) at published width and depth
TRAIN_LM = (("smollm-360m", 8, 1024, 6), ("mamba2-130m", 8, 1024, 3))


def _device_ms(run) -> float:
    """Summed device time (ms) of the kernels `run()` launches, from
    torch.profiler (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def _count_row(tag, fake, real, peak, model_flops, dtype, ms) -> dict:
    from repro_torch.launch import roofline as rl

    cost = {"flops": real["flops"], "bytes accessed": real["bytes"]}
    roof = rl.analyze(cost, real["coll"], model_flops, 1, compute_dtype=dtype)
    row = {"tag": tag, "flops": real["flops"], "bytes": real["bytes"],
           "fake_flops": fake["flops"], "fake_bytes": fake["bytes"],
           "fake_temp_bytes": fake["memory"]["temp_bytes"],
           "real_peak_bytes": peak, "kernel_ms": ms,
           "tflops": real["flops"] / (ms * 1e-3) / 1e12 if ms else float("nan"),
           "t_compute_ms": roof.t_compute * 1e3, "t_memory_ms": roof.t_memory * 1e3,
           "useful_ratio": roof.useful_ratio,
           "fake_coll": fake["coll"]["counts"], "real_coll": real["coll"]["counts"]}
    log(f"[count] {tag}: {real['flops']:.4e} FLOPs, {real['bytes']:.4e} bytes "
        f"(fake {fake['flops']:.4e}, {fake['bytes']:.4e}); kernels "
        f"{ms:.2f} ms -> {row['tflops']:.1f} TFLOP/s; t_compute "
        f"{row['t_compute_ms']:.2f} ms, t_memory {row['t_memory_ms']:.2f} ms "
        f"(roofline at H100 SXM datasheet peaks); useful {roof.useful_ratio:.2f}; "
        f"peak {peak / 2**30:.2f} GiB real, {fake['memory']['temp_bytes'] / 2**30:.2f} "
        f"GiB counted; collectives fake {fake['coll']['counts']} real "
        f"{real['coll']['counts']}; {card_and_power_limit()}")
    if fake["flops"] != real["flops"] or fake["bytes"] != real["bytes"]:
        raise AssertionError(f"[count] {tag}: fake and real counts differ")
    return row


def _count_lm_step() -> dict:
    """Phase 13.1: smollm-360m's train step counted on fake and on real
    tensors, no mesh installed (shardctx is the identity)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import roofline as rl
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.specs import Cell
    from repro_torch.launch.steps import TrainState, init_train_state, make_train_step
    from repro_torch.models import LM, get_arch

    cfg = get_arch(COUNT_ARCH)
    b, s = COUNT_SHAPE
    step = make_train_step(cfg, None)
    rng = np.random.default_rng(DATA_SEED)
    tok = rng.integers(0, cfg.vocab, size=(b, s + 1)).astype(np.int32)
    with FakeTensorMode():
        params = {k: torch.empty(p.shape, dtype=torch.bfloat16, device=DEV)
                  for k, p in LM(cfg, device="meta").named_parameters()}
        mu = {k: torch.zeros(p.shape, dtype=torch.float32, device=DEV)
              for k, p in params.items()}
        st = TrainState(params, mu, {k: v.clone() for k, v in mu.items()},
                        torch.zeros((), dtype=torch.int32, device=DEV))
        fb = {"tokens": torch.empty((b, s), dtype=torch.int32, device=DEV),
              "targets": torch.empty((b, s), dtype=torch.int32, device=DEV)}
        fake = count_step(lambda: step(st, fb), external=(st, fb))
    del st, fb, params, mu
    state = init_train_state(cfg, torch.Generator(device=DEV).manual_seed(DATA_SEED),
                             device=DEV)
    batch = {"tokens": torch.as_tensor(tok[:, :-1], device=DEV),
             "targets": torch.as_tensor(tok[:, 1:], device=DEV)}
    step(state, batch)                      # warm-up: cuBLAS handles, caches
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    real = count_step(lambda: step(state, batch), external=(state, batch))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    ms = _device_ms(lambda: step(state, batch))
    mf = rl.model_flops_for(cfg, Cell(cfg.name, "train", "train", b, s))
    row = _count_row(f"{COUNT_ARCH} train {b}x{s} bf16", fake, real, peak, mf,
                     "bf16", ms)
    rel = abs(fake["memory"]["temp_bytes"] - peak) / peak
    log(f"[count] counted peak vs max_memory_allocated: {rel:.3f} relative")
    if rel > COUNT_MEM_TOL:
        raise AssertionError(f"[count] counted peak off by {rel:.3f}")
    row["mem_rel"] = rel
    return row


_FAKE_GP_COUNT = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
from repro_torch.configs.gp_exact_1m import CONFIG
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, init_fake_world
init_fake_world(1)
mesh = Mesh((1, 1), ("data", "model"), device=torch.device(sys.argv[2]))
gp = CONFIG._replace(n=int(sys.argv[3]), backend="partitioned")
r = dryrun.count_gp_cell(gp, "gp_predict", mesh, int(sys.argv[4]))
print(json.dumps({k: r[k] for k in ("flops", "bytes", "coll", "memory")}))
"""


def _count_gp_predict() -> dict:
    """Phase 13.2: the GP predict cell (the mean-cache solve, fixed trips)
    at n = 2^15 on a one-rank NCCL group, counted for real; the fake count
    runs in a subprocess on a `fake` group of world 1 (same ops)."""
    from repro_torch.configs.gp_exact_1m import CONFIG
    from repro_torch.core.distributed import shard_vector
    from repro_torch.core.kernels_math import init_params
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import gp_cells
    from repro_torch.launch.steps import make_gp_predict_setup

    out = subprocess.run(
        [sys.executable, "-c", _FAKE_GP_COUNT, os.path.join(HERE, "src"), DEV,
         str(COUNT_GP_N), str(COUNT_GP_ITERS)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="4"))
    if out.returncode:
        raise RuntimeError(f"[count] fake GP count failed:\n{out.stderr[-3000:]}")
    fake = json.loads(out.stdout.strip().splitlines()[-1])

    gp = CONFIG._replace(n=COUNT_GP_N, backend="partitioned",
                         pred_cg_iters=COUNT_GP_ITERS)
    mesh = make_host_mesh(device=DEV)       # a one-rank NCCL group
    solve, geom = make_gp_predict_setup(gp, mesh, fixed_iters=True)
    rng = np.random.default_rng(DATA_SEED)
    X = torch.as_tensor(rng.normal(size=(gp.n, gp.d)), dtype=torch.float32, device=DEV)
    y = shard_vector(mesh, geom, torch.as_tensor(rng.normal(size=gp.n),
                                                 dtype=torch.float32))
    params = init_params(noise=0.5, device=DEV)
    solve(X, y, params)                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    real = count_step(lambda: solve(X, y, params), external=(X, y, params))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    ms = _device_ms(lambda: solve(X, y, params))
    cell = [c for c in gp_cells(gp) if c.kind == "gp_predict"][0]
    return _count_row(f"gp predict n={gp.n} {gp.pred_cg_iters} CG fp32", fake,
                      real, peak, rl.model_flops_for(gp, cell), "float32", ms)


def _start_dryrun():
    """Phase 13.3, started: `python -m repro_torch.launch.dryrun --arch
    smollm-360m,gp-exact-1m` on the (16, 16) fake mesh, in a process of its
    own (the fake group of 256 ranks must be its only group). It counts on
    the host's cores while the card runs phases 13.1-13.2."""
    out_dir = os.path.join(HERE, "build", "dryrun_torch")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    logs = [open(os.path.join(HERE, "build", f"dryrun_torch.{k}"), "w")
            for k in ("out", "err")]
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         DRYRUN_ARCHS, "--out", out_dir],
        stdout=logs[0], stderr=logs[1],
        env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
                 OMP_NUM_THREADS="2"))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return {"proc": proc, "out_dir": out_dir, "logs": logs,
            "t0": time.perf_counter()}


def _dryrun_cells(run) -> list:
    """Phase 13.3, collected: every cell `ok` but long_500k (`skipped`);
    each cell's roofline row and seconds printed."""
    from repro_torch.launch import roofline as rl

    try:
        rc = run["proc"].wait(timeout=900)
    finally:
        if run["proc"].poll() is None:
            run["proc"].kill()
            run["proc"].wait()
        for f in run["logs"]:
            f.close()
    seconds = time.perf_counter() - run["t0"]
    out_dir = run["out_dir"]
    if rc:
        errors = []
        for name in sorted(os.listdir(out_dir)):
            with open(os.path.join(out_dir, name)) as f:
                r = json.load(f)
            if r["status"] == "error":
                errors.append(f"{name}:\n{r['traceback'][-4000:]}")
        with open(run["logs"][0].name) as f:
            raise RuntimeError(f"[dryrun] failed:\n{f.read()[-3000:]}\n"
                               + "\n".join(errors))
    rows = []
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as f:
            r = json.load(f)
        cell = r["cell"]
        if r["status"] == "skipped":
            if cell["shape"] != "long_500k":
                raise AssertionError(f"[dryrun] {name} skipped")
            log(f"[dryrun] {cell['arch']} {cell['shape']}: skipped ({r['reason']})")
            rows.append({"cell": cell, "status": "skipped"})
            continue
        if r["status"] != "ok":
            raise AssertionError(f"[dryrun] {name}: {r['status']}")
        roof = rl.Roofline(**r["roofline"])
        log(f"[dryrun] {rl.format_row(cell['arch'], cell['shape'], r['mesh'], roof)}"
            f" {r['compile_s']} s")
        rows.append({"cell": cell, "status": "ok", "roofline": r["roofline"],
                     "seconds": r["compile_s"]})
    archs = DRYRUN_ARCHS.split(",")
    want = sum(2 if a == "gp-exact-1m" else 4 for a in archs)  # GP: train, predict
    if len(rows) != want:
        raise AssertionError(f"[dryrun] {len(rows)} cells, {want} expected")
    log(f"[dryrun] {len(rows)} cells in {seconds:.1f} s on the card's host "
        f"(beside phases 13.1-13.2); {card_and_power_limit()}")
    return rows


def phase_count() -> dict:
    """Phase 13: the dry run's counter on the card (see the module
    docstring); the dry run's own process runs beside 13.1-13.2 and is
    collected before the phase ends, so that phase 14 runs alone."""
    t_phase = time.perf_counter()
    dry = _start_dryrun()
    lm = _count_lm_step()
    gp = _count_gp_predict()
    log(f"[count] phases 13.1-13.2 in {time.perf_counter() - t_phase:.1f} s "
        f"on {card_and_power_limit()}")
    cells = _dryrun_cells(dry)
    seconds = time.perf_counter() - t_phase
    return {"lm": lm, "gp": gp, "dryrun": cells, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 14: the LM trainer
# ---------------------------------------------------------------------------


def _train_argv(arch, b, s, steps, ckpt, every) -> list:
    return ["--arch", arch, "--full", "--batch", str(b), "--seq", str(s),
            "--steps", str(steps), "--ckpt", ckpt, "--ckpt-every", str(every),
            "--log-every", "1", "--lr", "1e-3", "--device", DEV]


def _train_lm_smollm(arch, b, s, steps, root) -> dict:
    """Phase 14.1: train, resume, SIGTERM and the NaN skip on the launcher."""
    import signal

    from repro_torch.launch.train import main as train_main
    from repro_torch.train.checkpoint import (
        CheckpointManager, load_checkpoint, tree_from_numpy)

    half = steps // 2
    ckpt = os.path.join(root, "run")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    first = train_main(_train_argv(arch, b, s, half, ckpt, half))
    peak = torch.cuda.max_memory_allocated()
    seen = []

    def spy(step_fn):
        def f(state, batch):
            if not seen:
                seen.append({k: v.clone() for k, v in state.params.items()})
            return step_fn(state, batch)
        return f

    second = train_main(_train_argv(arch, b, s, steps, ckpt, half), wrap_step=spy)
    name = first["ckpt_dir"]
    tree, _, _ = load_checkpoint(name, first["state"], step=half)
    saved = tree_from_numpy(first["state"], tree).params
    restored_equal = all(torch.equal(v.view(torch.int16), saved[k].view(torch.int16))
                         for k, v in seen[0].items())
    losses = first["losses"] + second["losses"]
    log(f"[train-lm] {arch}: losses {[round(x, 4) for x in losses]}; resumed "
        f"at step {half}, restored parameters equal the step-{half} checkpoint "
        f"bit for bit: {restored_equal}")
    if not (second["steps_run"] == steps - half and restored_equal):
        raise AssertionError("[train-lm] resume gate failed")
    if not all(math.isfinite(x) for x in losses) or \
            not np.mean(losses[-2:]) < losses[0]:
        raise AssertionError(f"[train-lm] loss gate failed: {losses}")

    # SIGTERM from a step hook while step 2 runs: a final checkpoint at 2
    calls = []

    def term(step_fn):
        def f(state, batch):
            calls.append(int(state.step))
            if int(state.step) == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return step_fn(state, batch)
        return f

    ck_term = os.path.join(root, "term")
    res = train_main(_train_argv(arch, b, s, steps, ck_term, 100), wrap_step=term)
    latest = CheckpointManager(os.path.join(ck_term, os.path.basename(name))).latest_step()
    log(f"[train-lm] SIGTERM during step 2: {res['steps_run']} steps run, "
        f"final checkpoint at step {latest}")
    if not (res["steps_run"] == 2 and latest == 2):
        raise AssertionError("[train-lm] SIGTERM gate failed")

    # a step that returns a NaN loss once is skipped; the state is kept
    given = []

    def nan_once(step_fn):
        def f(state, batch):
            given.append(state)
            new, metrics = step_fn(state, batch)
            if len(given) == 2:
                metrics = dict(metrics, loss=torch.full_like(metrics["loss"],
                                                             float("nan")))
            return new, metrics
        return f

    res = train_main(_train_argv(arch, b, s, 2, os.path.join(root, "nan"), 100),
                     wrap_step=nan_once)
    kept = given[2] is given[1] and all(
        torch.equal(given[2].params[k].view(torch.int16),
                    given[1].params[k].view(torch.int16)) for k in given[1].params)
    log(f"[train-lm] NaN loss once: {res['skipped']} skipped, state kept bit "
        f"for bit: {kept}")
    if not (res["skipped"] == 1 and res["steps_run"] == 2 and kept):
        raise AssertionError("[train-lm] NaN-skip gate failed")
    return {"arch": arch, "losses": losses, "tokens_per_s": second["tokens_per_s"],
            "peak_gib": peak / 2**30, "batch": b, "seq": s}


def _step_split(arch, b, s) -> dict:
    """One train step of `arch` at b x s, as the launcher runs it (bf16
    weights, fp32 moments, the synthetic stream's first batch): its wall
    time on the host clock (synchronized; the median of 3 steps after a
    warm-up step) beside the profiler's summed kernel time of one more
    step (a device time, steady from step to step)."""
    from repro_torch.data.tokens import _synth_stream
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.models import get_arch

    cfg = get_arch(arch)
    step = make_train_step(cfg, None, lr=1e-3)
    state = init_train_state(cfg, torch.Generator(device=DEV).manual_seed(DATA_SEED),
                             device=DEV)
    batch = {k: torch.as_tensor(v, device=DEV) for k, v in
             next(_synth_stream(cfg.vocab, b, s, DATA_SEED)).items()}
    step(state, batch)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    kern = _device_ms(lambda: step(state, batch))
    del state, batch
    torch.cuda.empty_cache()
    wall = float(np.median(walls))
    log(f"[train-lm] {arch} step at {b} x {s}: {wall:.1f} ms wall, {kern:.1f} ms "
        f"of kernels (the card busy {100 * kern / wall:.1f}%); "
        f"{card_and_power_limit()}")
    return {"wall_ms": wall, "kernel_ms": kern}


def phase_train_lm() -> dict:
    """Phase 14: `launch.train`'s LM path in-process (see the module
    docstring)."""
    from repro_torch.launch.train import main as train_main

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    rows = []
    try:
        arch, b, s, steps = TRAIN_LM[0]
        rows.append(_train_lm_smollm(arch, b, s, steps, root))
        arch, b, s, steps = TRAIN_LM[1]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res = train_main(_train_argv(arch, b, s, steps,
                                     os.path.join(root, arch), 100))
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) for x in res["losses"]) or \
                len(res["losses"]) != steps:
            raise AssertionError(f"[train-lm] {arch}: {res['losses']}")
        rows.append({"arch": arch, "losses": res["losses"],
                     "tokens_per_s": res["tokens_per_s"],
                     "peak_gib": peak / 2**30, "batch": b, "seq": s})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for r in rows:
        r.update(_step_split(r["arch"], r["batch"], r["seq"]))
    card = card_and_power_limit()
    for r in rows:
        log(f"[train-lm] {r['arch']} --full (bf16 weights, fp32 moments), batch "
            f"{r['batch']} x seq {r['seq']}: {r['tokens_per_s']:,.0f} tokens/s, "
            f"peak {r['peak_gib']:.2f} GiB; {card}")
    seconds = time.perf_counter() - t_phase
    log(f"[train-lm] phase 14 in {seconds:.1f} s on {card}")
    return {"rows": rows, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 14c: the sharded train step
# ---------------------------------------------------------------------------

# (arch, global batch, seq, steps): the phase-14 smollm run's shape, bf16
SHARDED_LM = ("smollm-360m", 8, 1024, 3)
SHARDED_LOSS_TOL = 3e-5        # relative, per step
VAL_TOL_LM = 3e-5              # loss / grad_norm / ce, the host-CPU check
SHARDED_PARAM_TOL = 2e-4       # of max|param|, after step 1
# the host-CPU check (gloo, world 2): (arch, mesh) at the reduced configs,
# one fp32 step at lr 1e-6 on a global batch of 4 x 64 against one rank
HOST_CPU_CASES = (("smollm-360m", (2, 1)), ("smollm-360m", (1, 2)),
                  ("granite-moe-3b-a800m", (1, 2)))


def _same_bits(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        kind = {2: torch.int16, 4: torch.int32}[a.element_size()]
        a, b = a.view(kind), b.view(kind)
    return bool(torch.equal(a, b))


def _plain(state):
    """A sharded TrainState's full tensors (gathers on every rank)."""
    from repro_torch.launch.steps import TrainState

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t
    return TrainState({k: full(v) for k, v in state.params.items()},
                      {k: full(v) for k, v in state.mu.items()},
                      {k: full(v) for k, v in state.nu.items()}, full(state.step))


def _steps_timed(step, state, batches) -> tuple:
    """Run `step` over `batches` from `state`: (losses, the parameters
    after step 1, the final state, each step's ms on the host clock,
    synchronized)."""
    losses, ms, first = [], [], None
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        loss = met["loss"]
        losses.append(float(loss.full_tensor() if hasattr(loss, "full_tensor")
                            else loss))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if first is None:
            first = state.params
    return losses, first, state, ms


def _host_rank(rank, world, store, out_dir):
    """One rank of the host-CPU check: each case's sharded step on a gloo
    mesh against the one-rank step on the same state and global batch.
    Saves the errors to out_dir/rank<r>.pt."""
    import torch.distributed as dist

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (
        init_train_state, make_train_step, place_train_state)
    from repro_torch.models import get_arch

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    out = {}
    try:
        for arch, shape in HOST_CPU_CASES:
            cfg = get_arch(arch).reduced()
            state = init_train_state(cfg, torch.Generator().manual_seed(0),
                                     dtype=torch.float32, device="cpu")
            mesh = make_host_mesh(*shape, device="cpu")
            batch = {}
            for key, m in (("plain", None), ("sharded", mesh)):
                pipe = TokenPipeline(m, cfg.vocab, 4, 64, seed=0, device="cpu")
                b = next(pipe)
                pipe.close()
                batch[key] = {"tokens": b.tokens, "targets": b.targets}
            plain_new, plain_met = make_train_step(cfg, None, lr=1e-6)(
                state, batch["plain"])
            step = make_train_step(cfg, mesh, lr=1e-6)
            new, met = step(place_train_state(mesh, state), batch["sharded"])
            new = _plain(new)
            err = {k: abs(float(met[k].full_tensor() if hasattr(met[k], "full_tensor")
                                else met[k]) - float(plain_met[k]))
                   / abs(float(plain_met[k])) for k in ("loss", "grad_norm", "ce")}
            for part in ("params", "mu", "nu"):
                err[part] = max(
                    float((getattr(new, part)[k] - v).abs().max()
                          / v.abs().max().clamp(min=1e-30))
                    for k, v in getattr(plain_new, part).items())
            out[f"{arch} {shape}"] = {"err": err, "fallbacks": dict(step.fallbacks)}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _host_cpu_check() -> dict:
    """The port-only part of tests/test_torch_lm_dist.py (a) on this host's
    CPU and torch: a gloo world of 2, one step per case of
    `HOST_CPU_CASES` against the one-rank step. Gates: loss, grad_norm and
    ce within 3e-5 relative, parameters and both moments within 2e-4 of
    their largest entry, on both ranks."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
    try:
        mp.spawn(_host_rank, args=(2, os.path.join(tmp, "store"), tmp), nprocs=2,
                 join=True)
        outs = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for case in outs[0]:
        errs = [o[case]["err"] for o in outs]
        worst = {k: max(e[k] for e in errs) for k in errs[0]}
        log(f"[train-sharded] host-CPU check (gloo, world 2, torch "
            f"{torch.__version__}), {case} reduced, one fp32 step vs one rank: "
            f"relative errors {json.dumps(worst)}; ran replicated: "
            f"{outs[0][case]['fallbacks']}")
        if not (all(worst[k] <= VAL_TOL_LM for k in ("loss", "grad_norm", "ce"))
                and all(worst[k] <= SHARDED_PARAM_TOL for k in ("params", "mu", "nu"))):
            raise AssertionError(f"[train-sharded] host-CPU check failed: {case}")
    return {case: max(o[case]["err"]["params"] for o in outs) for case in outs[0]}


def phase_train_sharded() -> dict:
    """Phase 14c: the sharded train step (see the module docstring)."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (
        TrainState, init_train_state, make_train_step, place_train_state)
    from repro_torch.models import get_arch
    from repro_torch.models.shardctx import REPLICATE_OK
    from repro_torch.train.checkpoint import (
        load_checkpoint, save_checkpoint, tree_from_numpy)

    t_phase = time.perf_counter()
    arch, b, s, n = SHARDED_LM
    cfg = get_arch(arch)
    mesh = make_host_mesh(1, 1, device=DEV)   # NCCL: the card's group
    state = init_train_state(cfg, torch.Generator(device=DEV).manual_seed(DATA_SEED),
                             device=DEV)
    batches = {}
    for key, m in (("plain", None), ("sharded", mesh)):
        pipe = TokenPipeline(m, cfg.vocab, b, s, seed=DATA_SEED, device=DEV)
        batches[key] = [{"tokens": x.tokens, "targets": x.targets}
                        for x in (next(pipe) for _ in range(n))]
        pipe.close()
    if not all(_same_bits(sb[k].full_tensor(), pb[k]) for sb, pb in
               zip(batches["sharded"], batches["plain"]) for k in sb):
        raise AssertionError("[train-sharded] the two streams differ")

    sharded_step = make_train_step(cfg, mesh, lr=1e-3)
    placed = place_train_state(mesh, state)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    s_losses, s_first, s_final, s_ms = _steps_timed(sharded_step, placed,
                                                     batches["sharded"])
    peak = torch.cuda.max_memory_allocated()
    s_first = {k: v.full_tensor() for k, v in s_first.items()}
    del placed
    p_losses, p_first, p_final, p_ms = _steps_timed(
        make_train_step(cfg, None, lr=1e-3), state, batches["plain"])
    del state
    loss_err = [abs(a - c) / abs(c) for a, c in zip(s_losses, p_losses)]
    param_err = max(float((s_first[k] - v).abs().max().float()
                          / v.abs().max().float()) for k, v in p_first.items())
    first_bits = all(_same_bits(s_first[k], v) for k, v in p_first.items())
    s_plain = _plain(s_final)
    final_bits = all(_same_bits(getattr(s_plain, part)[k], v)
                     for part in ("params", "mu", "nu")
                     for k, v in getattr(p_final, part).items())
    del s_first, p_first
    card = card_and_power_limit()
    log(f"[train-sharded] {arch} --full, bf16 weights, fp32 moments, {b} x {s}, "
        f"{mesh}: losses {s_losses} vs the plain path's {p_losses} "
        f"(relative {max(loss_err):.3g}); after step 1 the parameters within "
        f"{param_err:.3g} of max|param|, bit for bit: {first_bits}; after "
        f"step {n} the whole state bit for bit: {final_bits}")
    log(f"[train-sharded] median step: sharded {float(np.median(s_ms)):.1f} ms, "
        f"plain {float(np.median(p_ms)):.1f} ms (steps {[round(x, 1) for x in s_ms]}"
        f" vs {[round(x, 1) for x in p_ms]}); sharded peak {peak / 2**30:.2f} GiB; "
        f"ran replicated: {sharded_step.fallbacks}; {card}")
    if not (max(loss_err) <= SHARDED_LOSS_TOL and param_err <= SHARDED_PARAM_TOL
            and set(sharded_step.fallbacks) <= REPLICATE_OK):
        raise AssertionError("[train-sharded] the sharded path disagrees")

    # the sharded state's checkpoint (gathered, written by rank 0) against
    # the same state's as plain tensors; then restored onto either path
    root = tempfile.mkdtemp(prefix="chip_smoke_shard_ck_")
    try:
        save_checkpoint(os.path.join(root, "sharded"), n, s_final)
        save_checkpoint(os.path.join(root, "plain"), n, s_plain)
        manifests = []
        for key in ("sharded", "plain"):
            with open(os.path.join(root, key, f"step_{n:08d}", "MANIFEST.json")) as f:
                manifests.append(json.load(f)["arrays"])
        arrays, _, _ = load_checkpoint(os.path.join(root, "sharded"), s_plain)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    restored = tree_from_numpy(s_plain, arrays)
    del arrays
    restored_bits = all(_same_bits(getattr(restored, part)[k], v)
                        for part in ("params", "mu", "nu")
                        for k, v in getattr(s_plain, part).items()) and \
        _same_bits(restored.step, s_plain.step)
    extra = batches["plain"][0]
    _, met_plain = make_train_step(cfg, None, lr=1e-3)(restored, extra)
    _, met_shard = sharded_step(place_train_state(mesh, restored),
                                batches["sharded"][0])
    l_plain, l_shard = float(met_plain["loss"]), float(met_shard["loss"].full_tensor())
    log(f"[train-sharded] checkpoint of the sharded state == the plain "
        f"state's: {manifests[0] == manifests[1]} ({len(manifests[0])} arrays, "
        f"crc32 each); restored onto the plain path bit for bit: "
        f"{restored_bits}; one more step from it: plain loss {l_plain}, "
        f"sharded {l_shard}")
    if not (manifests[0] == manifests[1] and restored_bits
            and math.isfinite(l_plain)
            and abs(l_shard - l_plain) <= SHARDED_LOSS_TOL * abs(l_plain)):
        raise AssertionError("[train-sharded] checkpoint gate failed")
    del s_final, s_plain, p_final, restored, batches
    torch.cuda.empty_cache()

    host = _host_cpu_check()
    seconds = time.perf_counter() - t_phase
    log(f"[train-sharded] phase 14c in {seconds:.1f} s on {card}")
    return {"sharded_ms": float(np.median(s_ms)), "plain_ms": float(np.median(p_ms)),
            "sharded_steps_ms": s_ms, "plain_steps_ms": p_ms,
            "losses": s_losses, "plain_losses": p_losses,
            "param_err": param_err, "first_bits": first_bits,
            "final_bits": final_bits, "peak_gib": peak / 2**30,
            "fallbacks": dict(sharded_step.fallbacks), "host_cpu": host,
            "seconds": seconds}


def main() -> None:
    if sys.argv[1:]:
        raise SystemExit(f"chip_smoke.py takes no arguments, got {sys.argv[1:]}")
    name = phase_device()
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.data.synthetic import make_regression_dataset

    t0 = time.perf_counter()
    phase_build()
    s = make_regression_dataset("houseelectric", seed=DATA_SEED,
                                max_points=N_TRAIN * 9 // 4)
    X_train = torch.as_tensor(np.asarray(s.X_train[:N_TRAIN], np.float32),
                              device=DEV)
    kern = phase_kernels(X_train)
    b5 = phase_kgrad(X_train)
    del X_train
    Xf, yf, lf = make_spatial_field(SPATIAL_N + SPATIAL_TEST, seed=DATA_SEED)
    b4 = phase_blocksparse(Xf[:SPATIAL_N])
    serve = phase_serve(s.X_test)
    from repro_torch.serve import load_artifact

    art = load_artifact(serve["artifact"], device=DEV)
    tuned = phase_autotune(
        art, torch.as_tensor(s.y_train[:N_TRAIN], dtype=torch.float32,
                             device=DEV), s.X_test)
    table1 = phase_table1(serve, art, s)
    traced = phase_traced_fit(s)
    del art, s
    spatial = phase_spatial(Xf[:SPATIAL_N], yf[:SPATIAL_N],
                            Xf[SPATIAL_N:], lf[SPATIAL_N:])
    Xc, yc, _ = make_spatial_field(CROSSCHECK_N, seed=DATA_SEED)
    phase_crosscheck(Xc, yc)
    b3 = phase_chunk()
    dist_run = phase_distributed()
    phase_dist_crosscheck(Xc, yc)
    import torch.distributed as dist

    dist.destroy_process_group()
    shutil.rmtree(dist_run["store_dir"], ignore_errors=True)
    dkl = phase_dkl()
    serve_lm = phase_serve_lm()
    count = phase_count()
    train_lm = phase_train_lm()
    sharded = phase_train_sharded()
    dist.destroy_process_group()
    log(f"[smoke] phases done in {time.perf_counter() - t0:.1f} s (phase 12 "
        f"{serve_lm['seconds']:.1f} s, phase 13 {count['seconds']:.1f} s, "
        f"phase 14 {train_lm['seconds']:.1f} s, phase 14c "
        f"{sharded['seconds']:.1f} s) on {card_and_power_limit()}")

    kernels = []
    sources = {"kmvm": ("src/repro_torch/kernels/csrc/kmvm.cu",
                        "src/repro/kernels/kmvm.py:317"),
               "kmvm_dots": ("src/repro_torch/kernels/csrc/kmvm.cu",
                             "src/repro/kernels/kmvm.py:184")}
    for i, kname in enumerate(("kmvm", "kmvm_dots")):
        main_row = kern["rows"][kname][0]
        kernels.append({
            "name": kname, "route": "cuda", "source": sources[kname][0],
            "replaces": sources[kname][1], "matched": True,
            "launches": serve["launches_total"][kname],
            "fit_launches": serve["fit_launches"][kname],
            "from_dir_launches": serve["from_dir"]["launches"][kname],
            "fleet_launches": serve["fleet"]["launches_total"][kname],
            "observe_launches":
                serve["fleet"]["observe"]["observe_launches"][kname],
            "max_abs_err": kern["abs_err"][1][i],
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "tc_bound_ms": main_row["tc_bound_ms"],
            "library_ms": None, "shape": main_row["shape"],
            "timings": kern["rows"][kname],
            "dkl_launches": dkl["launches"][kname],
            "dkl_train_launches": dkl["train_launches"][kname],
            "dkl_max_abs_err": {t: e[i] for t, e in dkl["abs_err"].items()},
            "dkl_timings": dkl["rows"][kname],
            "autotune": {
                "tuned_split": tuned["splits"],
                "sweep_launches": {t: c[kname] for t, c in
                                   tuned["sweep_launches"].items()},
                "sweep_ms": tuned["sweep_ms"],
                "default_vs_tuned_ms": {
                    t: {k: v for k, v in tuned["timings"][f"real_t{t}"].items()
                        if k.startswith(KERNEL_LABEL[kname])}
                    for t in AUTOTUNE_T},
                "fit_launches": tuned["fit_launches"][kname],
                "max_abs_err": tuned["abs_err"]}})
    row = b4["rows"][0]
    kernels.append({
        "name": "kmvm_blocksparse", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/kmvm_sparse.cu",
        "replaces": "src/repro/sparse/kmvm_sparse.py:97", "matched": True,
        "launches": spatial["launches"]["kmvm_blocksparse"],
        "from_dir_launches":
            spatial["from_dir"]["launches"]["kmvm_blocksparse"],
        "train_launches": spatial["train_b4"],
        "fit_launches": spatial["fit_b4"],
        "observe_launches": spatial["observe"]["b4_launches"],
        "max_abs_err": b4["abs_err"][1], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "tc_bound_ms": row["tc_bound_ms"],
        "library_ms": None,
        "shape": row["shape"], "entries": row["entries"],
        "timings": b4["rows"], "cross_chunk_ms": spatial["cross_ms"],
        "cross_chunk_rel_err": spatial["cross_err"],
        "cross_chunk_plain_ms": spatial["cross_plain_ms"],
        "cross_chunk_bound_ms": spatial["cross_bound"]})
    kernels.append({
        "name": "kgrad", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/kgrad.cu",
        "replaces": None, "differentiates": "src/repro/core/partitioned.py:207",
        "matched": True, "launches_per_step": traced["b5_launches"],
        "max_rel_err": b5["max_rel_err"], "ms": b5["ms"], "grads_ms": b5["grads_ms"],
        "plain_ms": b5["plain_ms"], "autograd_ms": b5["autograd_ms"],
        "bound_ms": b5["bound_ms"], "bound_by": b5["bound_by"],
        "tc_bound_ms": b5["tc_bound_ms"], "library_ms": None, "shape": b5["shape"]})
    row = b3["rows"][1]  # t = 9, the training mBCG block
    kernels.append({
        "name": "kmvm_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/kmvm.cu",
        "replaces": "src/repro/kernels/kmvm.py:262", "matched": True,
        "launches": dist_run["launches"]["kmvm_chunk"],
        "train_launches": dist_run["train_counts"]["kmvm_chunk"],
        "solve_launches": dist_run["solve_iters"],
        "max_abs_err": b3["abs_err"][9], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "tc_bound_ms": row["tc_bound_ms"],
        "library_ms": None,
        "shape": row["shape"], "timings": b3["rows"]})
    log(f"[table1] {json.dumps(table1['rows'])}")
    log(f"[serve-lm] {json.dumps(serve_lm['rows'])}")
    log(f"[count] {json.dumps({'lm': count['lm'], 'gp': count['gp']})}")
    log(f"[train-lm] {json.dumps(train_lm['rows'])}")
    log(f"[train-sharded] {json.dumps(sharded)}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
