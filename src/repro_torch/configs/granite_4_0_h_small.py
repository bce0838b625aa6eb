"""granite-4.0-h-small [hf:ibm-granite/granite-4.0-h-small, config.json]:
40 layers d4096, a period of 10 (five Mamba-2, one NoPE GQA attention 32H
kv8 hd128, four Mamba-2), each mixer followed by a 72-expert top-10 MoE of
width 768 with a shared SwiGLU of 1536; muP multipliers (residual 0.22,
embedding 12, attention 1/128); tied vocabulary 100,352. 32B parameters,
9B active. A port-only configuration (`HybridMoEConfig`)."""
from repro_torch.models.hybrid_moe import HybridMoEConfig

_PERIOD = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4

CONFIG = HybridMoEConfig(
    name="granite-4.0-h-small",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=768, d_shared=1536, vocab=100352,
    layer_types=_PERIOD * 4,
    n_experts=72, top_k=10,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256, conv_kernel=4,
    residual_multiplier=0.22, embedding_multiplier=12.0,
    attention_multiplier=0.0078125, norm_eps=1e-5,
)
