"""FLOPs of the granitemoehybrid backbone (the DKL cell's), from its
configuration's config.json keys: 2 a multiply-add of every product the
layer equations need, the backward twice the forward's.

Per token and forward: a Mamba-2 layer's in_proj and out_proj, and its
scan's products over the causal (query, key) pairs of a sequence (C . B
and the weighted sum of the dt x rows); an attention layer's four
projections and its scores and weighted values over the causal pairs; every
layer's router and shared SwiGLU. Each routed (token, held expert) pair
adds one expert SwiGLU; the pairs come from the program's counter of every
forward's held pairs, over the forwards a step runs. Norms, the conv, gathers and elementwise work are
left out. Peaks: the H100 SXM data sheet's dense bf16 and TF32 rates."""

from __future__ import annotations

PEAK_BF16 = 989.4e12
PEAK_TF32 = 494.7e12


def dense_token_flops(cfg: dict, seq: int) -> float:
    """A forward's FLOPs per token of everything but the routed experts,
    over sequences of `seq` tokens."""
    d = cfg["hidden_size"]
    pairs = (seq + 1) / 2.0                  # causal pairs a token takes part in
    di = cfg["mamba_expand"] * d
    n, h, p = cfg["mamba_d_state"], cfg["mamba_n_heads"], cfg["mamba_d_head"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // hq
    mamba = 2 * d * (2 * di + 2 * n + h) + 2 * di * d + pairs * (2 * n + 2 * h * p)
    attention = 2 * d * (hq + 2 * hkv) * hd + 2 * hq * hd * d + pairs * 4 * hq * hd
    ffn = 2 * d * cfg["router_experts"] + 3 * 2 * d * cfg["shared_intermediate_size"]
    kinds = cfg["layer_types"][:cfg["num_hidden_layers"]]
    return float(sum(mamba if k == "mamba" else attention for k in kinds)
                 + len(kinds) * ffn)


def pair_flops(cfg: dict) -> float:
    """A forward's FLOPs of one routed expert SwiGLU on one token."""
    return 3 * 2 * float(cfg["hidden_size"]) * cfg["intermediate_size"]


def step_flops(cfg: dict, tokens: int, seq: int, pairs: float, steps: int) -> float:
    """The backbone's model FLOPs of `steps` steps over `tokens` tokens
    each: one forward and one backward (twice the forward) a step, whatever
    the program recomputes; `pairs` the held pairs of one forward of each of
    those steps, all told."""
    return 3.0 * (steps * tokens * dense_token_flops(cfg, seq) + pairs * pair_flops(cfg))
