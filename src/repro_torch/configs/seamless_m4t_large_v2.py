"""seamless-m4t-large-v2 [arXiv:2308.11596]: enc-dec 24L d1024 16H ff8192.

[audio]: the speech frontend is a stub -- input_specs supply precomputed
frame embeddings (B, S, d_model) to the encoder; the text decoder trains
with cross-attention. 24 encoder + 24 decoder layers.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, mlp="gelu", embed_input=False,
)
