"""Transformer blocks: the dense family.

The counterpart of the dense branch of `repro.models.blocks`
(`block_params`, `block_apply`): pre-norm GQA attention with RoPE and a
residual, then a pre-norm (Sw)iGLU or GeLU MLP and a residual. The other
families (moe, ssm, hybrid, encdec, vlm) and the cached decode path are
not ported yet: a block of any other family raises, naming the ROADMAP
item that ports it, and never falls through to the dense path.
"""

from __future__ import annotations

import torch
from torch import nn

from .attention import attention, attn_params, qkv_proj
from .layers import apply_norm, apply_rope, mlp_apply, mlp_params, norm_param

PORTED_FAMILIES = ("dense",)


def check_family(cfg) -> None:
    """Raise for a family the port does not have yet."""
    if cfg.family not in PORTED_FAMILIES or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; "
            "ROADMAP A2 (the other families) ports the moe, ssm, hybrid, "
            "encdec and vlm blocks")


class Block(nn.Module):
    """One dense block; parameters named as the reference's layer dict
    (`ln1`, `attn.{wq,wk,wv,wo}`, `ln2`, `mlp.{wi,wg,wo}`)."""

    def __init__(self, cfg, generator, dtype, device):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        d = cfg.d_model
        self.ln1 = norm_param(cfg.norm, d, dtype, device)
        self.attn = attn_params(generator, d, cfg.n_heads, cfg.n_kv_heads,
                                cfg.hd, dtype, device)
        self.ln2 = norm_param(cfg.norm, d, dtype, device)
        self.mlp = mlp_params(cfg.mlp, generator, d, cfg.d_ff, dtype, device)

    def _attn_branch(self, xn, positions):
        cfg = self.cfg
        q, k, v = qkv_proj(self.attn, xn, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        out = attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
        b, s = xn.shape[:2]
        return out.reshape(b, s, -1) @ self.attn["wo"]

    def forward(self, x, positions):
        """One block, training/prefill (full causal attention: the dense
        family has no sliding window). Returns (x, aux); aux (the MoE
        balance loss) is 0 for the dense family."""
        cfg = self.cfg
        x = x + self._attn_branch(apply_norm(cfg.norm, x, self.ln1), positions)
        x = x + mlp_apply(cfg.mlp, self.mlp, apply_norm(cfg.norm, x, self.ln2))
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
