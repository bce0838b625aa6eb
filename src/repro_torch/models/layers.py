"""Shared layers: norms, MLPs, rotary embeddings (RoPE and M-RoPE).

The counterpart of `repro.models.layers`. Parameters live in
`nn.ParameterDict`s keyed as the reference's dicts are (`wi`, `wg`, `wo`),
weights in the reference's `(in, out)` layout, so `x @ w` as there. The
compute dtype is the parameters' (bf16 by default, fp32 for deep kernel
learning); norms and rotary angles run in fp32 and cast back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device

from .shardctx import shard


def normal_init(shape, scale: float, generator, dtype, device) -> torch.Tensor:
    """scale * N(0, 1) drawn from `generator`; an empty tensor on the `meta`
    device (shapes only, as the reference's `jax.eval_shape`)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return scale * torch.randn(shape, generator=generator, dtype=dtype,
                               device=device)


def rmsnorm(x, scale, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)).to(x.dtype)


def np_layernorm(x, scale=None):
    """OLMo's non-parametric LayerNorm (no learnable affine; biased
    variance, as `jnp.var`)."""
    del scale
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype)


def apply_norm(kind: str, x, scale):
    if kind == "rmsnorm":
        return rmsnorm(x, scale)
    if kind == "np_layernorm":
        return np_layernorm(x)
    raise ValueError(kind)


def norm_param(kind: str, d: int, dtype, device=None) -> nn.Parameter:
    device = resolve_device(device)
    # np_layernorm keeps a dummy (1,) parameter so the layout (and the
    # parameter count) stays the reference's
    if kind == "np_layernorm":
        return nn.Parameter(torch.zeros((1,), dtype=dtype, device=device))
    return nn.Parameter(torch.ones((d,), dtype=dtype, device=device))


def mlp_apply(kind: str, p, x):
    """x (..., D) -> (..., D). swiglu: wi/wg/wo; gelu: wi/wo (tanh
    approximation, `jax.nn.gelu`'s default)."""
    if kind == "swiglu":
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    elif kind == "gelu":
        h = F.gelu(x @ p["wi"], approximate="tanh")
    else:
        raise ValueError(kind)
    h = shard(h, *(("fsdp",) + (None,) * (h.ndim - 2) + ("tp",)))  # F over model
    return h @ p["wo"]


def mlp_params(kind: str, generator, d: int, f: int, dtype,
               device=None) -> nn.ParameterDict:
    device = resolve_device(device)
    s_in = (2.0 / d) ** 0.5
    s_out = (2.0 / f) ** 0.5
    p = nn.ParameterDict({
        "wi": normal_init((d, f), s_in, generator, dtype, device),
        "wo": normal_init((f, d), s_out, generator, dtype, device),
    })
    if kind == "swiglu":
        p["wg"] = normal_init((d, f), s_in, generator, dtype, device)
    return p


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def _rotate(x, angles):
    """Split-half rotation of x (B, S, H, hd) by angles (B, S, hd/2): the
    first and second halves of hd pair up (not interleaved lanes)."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x (B, S, H, hd); positions (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # (hd/2,)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def apply_mrope(x, positions3, theta: float, sections: tuple):
    """Qwen2-VL multimodal RoPE. positions3 (3, B, S): (t, h, w) ids.

    The hd/2 frequency slots are split into `sections` (sum = hd/2); each
    section rotates by its own positional stream. Text tokens carry
    t = h = w, reducing to plain RoPE.
    """
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to hd/2 = {hd // 2}")
    freqs = rope_freqs(hd, theta, x.device)                    # (hd/2,)
    # angles per stream (3, B, S, hd/2), then each section's slots from its
    # own stream (slices, not an index tensor: nothing waits on the card)
    angles = positions3[..., None].to(torch.float32) * freqs
    ends = [sum(sections[:i + 1]) for i in range(3)]
    return _rotate(x, torch.cat([angles[i, ..., end - n:end] for i, (n, end)
                                 in enumerate(zip(sections, ends))], dim=-1))


def positions_for(cfg, batch: int, seq: int, offset=0, device=None):
    """Default position ids (B, S) int32; M-RoPE gets three identical text
    streams (3, B, S)."""
    pos = offset + torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    pos = pos.expand(batch, seq)
    if cfg.mrope_sections:
        return pos[None].expand(3, batch, seq)
    return pos


def apply_positional(cfg, x, positions):
    if cfg.mrope_sections:
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)
