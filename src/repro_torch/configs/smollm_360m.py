"""smollm-360m [hf:HuggingFaceTB/SmolLM]: llama-arch 32L d960 15H(kv5) ff2560."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152,
)
