"""qwen2-vl-7b [arXiv:2409.12191]: 28L d3584 28H(kv4), M-RoPE (16,24,24).

[vlm]: the vision tower is a stub -- input_specs supply precomputed patch
embeddings + an embed_mask; masked positions take the patch embedding in
place of the token embedding. M-RoPE carries (t, h, w) position streams.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064,
    mrope_sections=(16, 24, 24),
)
