"""Roofline terms for the dry run's counted cells, priced at H100 peaks.

The counterpart of `repro.launch.roofline`. Per (arch x shape x mesh) cell:
    compute    = FLOPs_per_device            / peak FLOP/s per card
    memory     = bytes_per_device            / HBM bytes/s per card
    collective = collective_bytes_per_device / link bytes/s per card

The counts are per device, as the reference's SPMD `cost_analysis` is: the
dry run counts the local ops one rank runs on its shards
(`repro_torch.launch.dryrun`). "Bytes" is every op's operands plus its
outputs, XLA's own definition of bytes accessed: an upper bound on HBM
traffic that ignores reuse in cache, applied alike to every cell.

Constants: H100 SXM5 datasheet peaks (NVIDIA H100 Tensor Core GPU
datasheet; the card the port runs on reports itself as "NVIDIA H100 80GB
HBM3" with a 700 W power limit through `nvidia-smi --query-gpu=name,
power.limit`):
    989 TFLOP/s dense bf16 (tensor cores, no sparsity)
     67 TFLOP/s IEEE fp32 (CUDA cores; `repro_torch.device` turns TF32 off,
        so fp32 matmuls do not run on the tensor cores)
   3.35 TB/s HBM3
     50 GB/s per card for the collective term: one 400 Gb/s NDR NIC per
        card. A 16 x 16 mesh spans 32 eight-card nodes, so its rings cross
        nodes; NVLink's 450 GB/s per direction holds only inside a node.

The reference parses collective sizes out of XLA's HLO text
(`collective_bytes`); the port has no HLO. `collective_stats` takes the
dry run's record of each collective one rank issued (its kind, the bytes
of its result and its group size; `CommDebugMode` counts the same calls)
and returns the reference's dict: the five kinds' operand bytes, `total`,
`wire` (the reference's ring formulas) and `counts`.
"""

from __future__ import annotations

from typing import NamedTuple

# H100 SXM5 per-card datasheet peaks (see the module docstring)
PEAK_FLOPS = 989e12        # bf16 FLOP/s, dense
PEAK_FLOPS_FP32 = 67e12    # IEEE fp32 FLOP/s
HBM_BW = 3.35e12           # bytes/s
LINK_BW = 50e9             # bytes/s per card, off-node


def peak_flops_for(compute_dtype: str | None) -> float:
    """Peak for the cell's matmul operand dtype: fp32 operands (the exact
    GP default) are charged at the fp32 rate, bf16 (the LM cells and the
    operator's mixed-precision path) at the tensor-core rate. One dtype is
    charged for the whole cell, as in the reference."""
    if compute_dtype in (None, "fp32", "float32", "f32"):
        return PEAK_FLOPS_FP32
    return PEAK_FLOPS


COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def collective_stats(records) -> dict:
    """Per-device collective operand bytes from (kind, result_bytes,
    group_size) records, one per collective, in the reference's dict
    (`repro.launch.roofline.collective_bytes`): all-gather operand =
    result / group; reduce-scatter operand = result x group; the rest are
    size-preserving. `wire` is the ring model's per-device link traffic."""
    out = {k: 0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    wire = 0.0
    for kind, result_bytes, gs in records:
        gs = max(int(gs), 1)
        if kind == "all-gather":
            operand_bytes = result_bytes // gs
            w = result_bytes * (gs - 1) / gs        # ring: recv ~result
        elif kind == "reduce-scatter":
            operand_bytes = result_bytes * gs
            w = result_bytes * (gs - 1)             # ring: send input once
        elif kind == "all-reduce":
            operand_bytes = result_bytes
            w = 2.0 * result_bytes * (gs - 1) / gs  # RS + AG phases
        elif kind == "all-to-all":
            operand_bytes = result_bytes
            w = result_bytes * (gs - 1) / gs
        elif kind == "collective-permute":
            operand_bytes = result_bytes
            w = result_bytes
        else:
            raise ValueError(f"unknown collective kind {kind!r}")
        out[kind] += operand_bytes
        counts[kind] += 1
        wire += w
    out["total"] = sum(out[k] for k in COLLECTIVES)
    out["wire"] = int(wire)
    out["counts"] = counts
    return out


class Roofline(NamedTuple):
    flops: float               # per-device flops
    bytes_accessed: float      # per-device bytes (operands + outputs)
    coll_bytes: float          # per-device collective operand bytes
    wire_bytes: float          # ring-model per-device link traffic
    t_compute: float
    t_memory: float
    t_collective: float        # operand-bytes basis
    t_collective_wire: float   # ring-model basis
    bottleneck: str
    model_flops: float         # "useful" flops per device (6ND / 2ND etc.)
    useful_ratio: float        # model_flops / flops


def analyze(cost: dict, coll: dict, model_flops_global: float,
            n_devices: int, compute_dtype: str = "bf16") -> Roofline:
    flops = float(cost.get("flops", 0.0) or 0.0)
    byts = float(cost.get("bytes accessed", 0.0) or 0.0)
    cb = float(coll["total"])
    wb = float(coll.get("wire", cb))
    t_c = flops / peak_flops_for(compute_dtype)
    t_m = byts / HBM_BW
    t_x = cb / LINK_BW
    t_w = wb / LINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_w}
    bott = max(terms, key=terms.get)
    mf = model_flops_global / max(n_devices, 1)
    return Roofline(flops=flops, bytes_accessed=byts, coll_bytes=cb,
                    wire_bytes=wb, t_compute=t_c, t_memory=t_m,
                    t_collective=t_x, t_collective_wire=t_w,
                    bottleneck=bott, model_flops=mf,
                    useful_ratio=(mf / flops if flops else 0.0))


def _lm_mixer_flops_fwd(cfg, batch: int, seq: int, *, decode_ctx=None) -> float:
    """Forward FLOPs of the sequence mixers (attention scores + values,
    SSD), the context-dependent compute 6ND misses. Causal halves the S^2
    term; sliding-window layers use min(S, W) context."""
    total = 0.0
    if cfg.n_heads:
        per_q_ctx = []
        for layer in range(cfg.n_layers):
            win = cfg.sliding_window
            if win and layer not in cfg.global_layers:
                ctx = min(seq, win) if decode_ctx is None else min(decode_ctx, win)
            else:
                ctx = (seq / 2.0) if decode_ctx is None else decode_ctx
            per_q_ctx.append(ctx)
        q_len = 1 if decode_ctx is not None else seq
        # QK^T + PV: 2 matmuls x 2 flops = 4 * B * q * ctx * hd * H
        total += sum(4.0 * batch * q_len * ctx * cfg.hd * cfg.n_heads
                     for ctx in per_q_ctx)
        if cfg.is_encdec:
            # decoder cross-attention (q tokens vs S_enc keys)
            q = 1 if decode_ctx is not None else seq
            total += cfg.n_layers * 4.0 * batch * q * seq * cfg.hd * cfg.n_heads
            # encoder self-attention (full, non-causal) in train/prefill only
            if decode_ctx is None:
                total += (cfg.n_enc_layers * 4.0 * batch * seq * seq *
                          cfg.hd * cfg.n_heads)
    if cfg.ssm_state:
        s_len = 1 if decode_ctx is not None else seq
        q, n_st, hp = cfg.ssm_chunk, cfg.ssm_state, cfg.ssm_heads * cfg.ssm_head_dim
        # intra-chunk (Gm + masked-decay PV) + state build/apply per token
        total += cfg.n_layers * batch * s_len * (
            2.0 * q * n_st + 2.0 * q * hp + 4.0 * n_st * hp)
    return total


def model_flops_for(cfg, cell) -> float:
    """Reference "useful" FLOPs (global; fwd + bwd for train, fwd for serve).

    LM: parameter matmuls (6 / 2 x N_active x tokens) plus the sequence
    mixers' context compute; remat recompute stays out, so useful_ratio
    shows it as overhead. GP: the CG-forward kernel MVMs, iters x 2 n^2
    (d + t); preconditioner build, CG dots and the backward land in
    overhead by design."""
    if cell.kind in ("gp_train", "gp_predict"):
        n, d = cfg.n, cfg.d
        t = 1 + (cfg.num_probes if cell.kind == "gp_train" else 0)
        iters = (cfg.train_cg_iters if cell.kind == "gp_train"
                 else cfg.pred_cg_iters)
        return iters * 2.0 * n * n * (d + t)
    from repro_torch.models import count_active_params

    n_active = count_active_params(cfg)
    if cell.kind == "train":
        return (6.0 * n_active * cell.batch * cell.seq +
                3.0 * _lm_mixer_flops_fwd(cfg, cell.batch, cell.seq))
    if cell.kind == "prefill":
        return (2.0 * n_active * cell.batch * cell.seq +
                _lm_mixer_flops_fwd(cfg, cell.batch, cell.seq))
    # decode: one token against a seq_len-deep context
    return (2.0 * n_active * cell.batch +
            _lm_mixer_flops_fwd(cfg, cell.batch, cell.seq,
                                decode_ctx=cell.seq))


def format_row(arch, shape, mesh_name, r: Roofline) -> str:
    return (f"| {arch} | {shape} | {mesh_name} | {r.flops:.3e} | "
            f"{r.bytes_accessed:.3e} | {r.coll_bytes:.3e} | "
            f"{r.t_compute*1e3:.2f} | {r.t_memory*1e3:.2f} | "
            f"{r.t_collective*1e3:.2f} | {r.bottleneck} | "
            f"{r.useful_ratio:.2f} |")
