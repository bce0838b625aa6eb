"""granite-moe-3b-a800m [hf:ibm-granite]: 32L d1536 24H(kv8) MoE 40e top-8.

The assignment line reads "MoE 40e top-8 -- 32 experts top-8"; we take the
structured field (40 experts) and note the free-text discrepancy here.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155,
    n_experts=40, top_k=8,
)
