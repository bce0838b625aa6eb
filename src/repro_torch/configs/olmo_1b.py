"""olmo-1b [arXiv:2402.00838]: 16L d2048 16H(kv16), NON-PARAMETRIC LayerNorm."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=50304, norm="np_layernorm",
)
