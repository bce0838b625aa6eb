"""Unified architecture config covering all 10 assigned families.

The port's own copy of `repro.models.config`, field for field (plain
Python; the port imports nothing of the reference).
"""

from __future__ import annotations

from typing import NamedTuple


class ArchConfig(NamedTuple):
    name: str
    family: str              # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int             # query heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int                # dense-MLP hidden (per-expert hidden for MoE)
    vocab: int
    head_dim: int = 0        # 0 -> d_model // n_heads
    norm: str = "rmsnorm"    # rmsnorm | np_layernorm (olmo)
    mlp: str = "swiglu"      # swiglu | gelu
    rope_theta: float = 1e6
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / hymba) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_kernel: int = 4
    # --- hybrid (hymba) ---
    sliding_window: int = 0        # 0 -> full attention everywhere
    global_layers: tuple = ()      # layer idxs with full attention
    # --- enc-dec (seamless) ---
    n_enc_layers: int = 0          # >0 -> encoder-decoder
    # --- vlm ---
    mrope_sections: tuple = ()     # e.g. (16, 24, 24) for qwen2-vl
    # --- modality stub ---
    embed_input: bool = False      # input_specs provide embeddings, not tokens
    # --- compute policy ---
    attn_chunk: int = 1024         # query-chunked attention block
    ce_chunk: int = 512            # cross-entropy sequence chunk
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """Can run long_500k: SSM or sliding-window hybrids."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:      # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def reduced(self, **overrides) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        small = dict(
            n_layers=2, d_model=64, d_ff=128, vocab=256,
            n_heads=max(self.n_heads // 4, 2) if self.n_heads else 0,
            head_dim=16 if self.n_heads else 0,
            attn_chunk=32, ce_chunk=32,
        )
        if self.n_kv_heads:
            # largest divisor of the reduced head count <= original kv count
            hq = small["n_heads"]
            cap = min(self.n_kv_heads, hq)
            small["n_kv_heads"] = max(k for k in range(1, cap + 1) if hq % k == 0)
        if self.n_experts:
            # capacity high enough that nothing drops: keeps the smoke
            # test's prefill+decode == forward consistency check exact
            small.update(n_experts=8, top_k=min(self.top_k, 2), d_ff=32,
                         capacity_factor=8.0)
        if self.n_shared_experts:
            small["n_shared_experts"] = 2
        if self.ssm_state:
            small.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.sliding_window:
            small.update(sliding_window=16, global_layers=(0,))
        if self.n_enc_layers:
            small["n_enc_layers"] = 2
        if self.mrope_sections:
            small["mrope_sections"] = (4, 2, 2)
        small["name"] = self.name + "-smoke"
        small.update(overrides)
        return self._replace(**small)
