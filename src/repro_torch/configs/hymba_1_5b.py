"""hymba-1.5b [arXiv:2411.13676]: parallel attn+mamba heads, SWA + 3 global.

Sliding-window (1024) everywhere except layers {0, 15, 31} (first/middle/
last full attention, per the paper). ssm_state=16. Sub-quadratic => runs
long_500k.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2,
    sliding_window=1024, global_layers=(0, 15, 31),
)
