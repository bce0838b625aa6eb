"""The granitemoehybrid family: a mixer per layer, then a dropless MoE FFN.

A port-only family (the JAX package has no counterpart), built for IBM's
Granite 4.0-H models (`granitemoehybrid` in their config.json). Every layer
is, with x the residual stream and r the residual multiplier:

    h  = x + r * Mixer_l(RMSNorm(x))
    x' = h + r * (Shared(RMSNorm(h)) + sum_{e in top-k, held} g_e Expert_e(RMSNorm(h)))

`Mixer_l` is the layer's kind in `layer_types`: "mamba", the Mamba-2 SSD of
`models/ssd.py` (one B/C group, conv with bias, gated RMSNorm over the
whole inner width, gate then norm), or "attention", causal GQA with no
positional encoding (NoPE) and the scores times `attention_multiplier`.
`Expert_e` and `Shared` are SwiGLUs. The embedding rows are scaled by
`embedding_multiplier`; the final RMSNorm closes the stack. Every RMSNorm
uses `norm_eps`.

Routing is per token over the whole batch and drops nothing: the router's
fp32 logits RMSNorm(h) W_r pick the top k experts, whose gates are a softmax
over those k logits. A layer may hold a share of the experts
(`expert_offset`, `experts_held`: expert parallelism without its exchange):
it routes over all `n_experts` and computes only its held experts' part.
The (token, expert) pairs of the held experts are sorted by expert,
gathered once, run through each expert as one product on its contiguous
segment, and added back weighted by their gates (`moe_dispatch` spans
around the sort and gather and around the combine, each holding its own
work on the card alone under tracing). Counters: `moe.routed_pairs_held`,
the held pairs of the router's choice; `moe.dropped`, those pairs less the
pairs the experts computed (0 here, where `dispatch` keeps every held
pair; a capacity in its place would show); the gauge
`moe.max_expert_pairs`, the largest held segment seen since it was last
reset. The segment sizes and the choice's held count are read on the host
together, once a layer. A recompute under `remat` runs and counts its
dispatch again.

Departures from the published model, each deliberate: the router's
auxiliary load-balance loss is left out (deep kernel learning trains on the
GP's marginal likelihood); the output head (tied logits over
`logits_scaling`) is not built, since the family serves as a feature
extractor, so `train_loss`, `prefill` and decoding raise.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import obs

from ..device import resolve_device
from .attention import attention, attn_params, qkv_proj
from .layers import mlp_apply, mlp_params, normal_init, norm_param, rmsnorm
from .shardctx import checkpoint
from .ssd import ssd_apply, ssd_params

FAMILY = "granitemoehybrid"
MIXERS = ("mamba", "attention")


class HybridMoEConfig(NamedTuple):
    """A granitemoehybrid architecture, with the names of the port's
    `ArchConfig` where a field means the same (config.json's key in the
    comment). Layer i runs `layer_types[i]`; a config holding fewer layers
    than the pattern lists runs its first `n_layers`."""

    name: str
    n_layers: int                  # num_hidden_layers
    d_model: int                   # hidden_size
    n_heads: int                   # num_attention_heads
    n_kv_heads: int                # num_key_value_heads
    d_ff: int                      # intermediate_size: one expert's width
    d_shared: int                  # shared_intermediate_size
    vocab: int                     # vocab_size (tied embeddings)
    layer_types: tuple             # layer_types: "mamba" | "attention"
    n_experts: int                 # num_local_experts: the router's width
    top_k: int                     # num_experts_per_tok
    head_dim: int = 0              # 0 -> d_model // n_heads
    expert_offset: int = 0         # first expert held here
    experts_held: int = 0          # experts held here (0 -> all n_experts)
    ssm_state: int = 128           # mamba_d_state
    ssm_head_dim: int = 64         # mamba_d_head
    ssm_expand: int = 2            # mamba_expand
    ssm_chunk: int = 256           # mamba_chunk_size
    conv_kernel: int = 4           # mamba_d_conv
    residual_multiplier: float = 1.0
    embedding_multiplier: float = 1.0
    attention_multiplier: float = 0.0   # 0 -> hd ** -0.5
    norm_eps: float = 1e-5         # rms_norm_eps
    family: str = FAMILY
    attn_chunk: int = 1024         # query-chunked attention block
    remat: bool = True             # per-layer checkpointing under autograd

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def held(self) -> range:
        """The experts this configuration computes."""
        count = self.experts_held or self.n_experts
        return range(self.expert_offset, self.expert_offset + count)


def is_hybrid_moe(cfg) -> bool:
    return getattr(cfg, "family", None) == FAMILY


class RoutedMoE(nn.Module):
    """The router (D, n_experts) fp32, the held experts' SwiGLUs `wi` / `wg`
    (H, D, F) and `wo` (H, F, D), and the shared SwiGLU `shared`."""

    def __init__(self, cfg: HybridMoEConfig, generator, dtype, device):
        super().__init__()
        d, f, h = cfg.d_model, cfg.d_ff, len(cfg.held)
        s, so = (2.0 / d) ** 0.5, (2.0 / f) ** 0.5
        self.router = nn.Parameter(normal_init((d, cfg.n_experts), 0.02, generator,
                                               torch.float32, device))
        self.wi = nn.Parameter(normal_init((h, d, f), s, generator, dtype, device))
        self.wg = nn.Parameter(normal_init((h, d, f), s, generator, dtype, device))
        self.wo = nn.Parameter(normal_init((h, f, d), so, generator, dtype, device))
        self.shared = mlp_params("swiglu", generator, d, cfg.d_shared, dtype, device)

    def forward(self, cfg: HybridMoEConfig, xn):
        """xn (B, S, D), normed -> Shared(xn) + the held experts' part."""
        return mlp_apply("swiglu", self.shared, xn) + routed_experts(self, cfg, xn)


@contextlib.contextmanager
def _dispatch_span(part: str, x):
    """A `moe_dispatch` span; under tracing it waits for the card on entry
    and on exit, so that it holds its own work on the card alone."""
    fence = obs.tracing_enabled() and x.is_cuda
    if fence:
        torch.cuda.synchronize(x.device)
    with obs.span("moe_dispatch", part=part):
        yield
        if fence:
            torch.cuda.synchronize(x.device)


def route(router, cfg: HybridMoEConfig, x):
    """x (T, D) -> the router's choice: its top k experts (T, k) and their
    gates (T, k) fp32, a softmax over the k logits."""
    logits = x.to(torch.float32) @ router                    # (T, E) fp32
    top_l, top_i = torch.topk(logits, cfg.top_k, dim=-1)
    return top_i, torch.softmax(top_l, dim=-1)


def dispatch(top_i, gates, held: range):
    """The held pairs of a choice, sorted by expert: their tokens and gates
    (the first sizes.sum() entries; the rest are other experts' pairs) and
    the segment size of each held expert (H,), on the device."""
    k, h = top_i.shape[1], len(held)
    local = top_i.reshape(-1) - held.start
    key = torch.where((local >= 0) & (local < h), local, h)  # others last
    order = torch.argsort(key, stable=True)
    sizes = torch.bincount(key, minlength=h + 1)[:h]
    return order // k, gates.reshape(-1)[order], sizes


def routed_experts(p, cfg: HybridMoEConfig, xn):
    """The held experts' part of the FFN for xn (B, S, D), in xn's dtype,
    accumulated in fp32."""
    b, s, d = xn.shape
    x = xn.reshape(b * s, d)
    held = cfg.held
    with _dispatch_span("route", x):
        top_i, gates = route(p.router, cfg, x)
        tok, gate, sizes = dispatch(top_i, gates, held)
        chosen = ((top_i >= held.start) & (top_i < held.stop)).sum()
        *sizes, chosen = torch.cat([sizes, chosen[None]]).tolist()
        pairs = sum(sizes)
        tok, gate = tok[:pairs], gate[:pairs]
        xs = x[tok]                                          # (P, D)
    # split and unbind (not slices and indices): their backwards assemble
    # each gradient once instead of adding a zero-filled full-size one per
    # expert
    ys = [(F.silu(xe @ wg) * (xe @ wi)) @ wo
          for xe, wi, wg, wo in zip(torch.split(xs, sizes), p.wi.unbind(0),
                                    p.wg.unbind(0), p.wo.unbind(0)) if xe.shape[0]]
    with _dispatch_span("combine", x):
        out = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
        if ys:
            out = out.index_add(0, tok, torch.cat(ys).to(torch.float32) * gate[:, None])
    obs.counter("moe.routed_pairs_held").inc(chosen)
    obs.counter("moe.dropped").inc(chosen - pairs)
    top = obs.gauge("moe.max_expert_pairs")
    top.set(max(top.value or 0, max(sizes, default=0)))
    return out.to(xn.dtype).reshape(b, s, d)


class HybridMoEBlock(nn.Module):
    """One layer: `ln1`, its mixer (`ssm` or `attn`), `ln2`, `moe`."""

    def __init__(self, cfg: HybridMoEConfig, kind: str, generator, dtype, device):
        super().__init__()
        if kind not in MIXERS:
            raise ValueError(f"{cfg.name}: unknown layer type {kind!r}; options: {MIXERS}")
        d = cfg.d_model
        self.kind = kind
        self.ln1 = norm_param("rmsnorm", d, dtype, device)
        if kind == "mamba":
            self.ssm = ssd_params(generator, cfg, dtype, device)
        else:
            self.attn = attn_params(generator, d, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.hd, dtype, device)
        self.ln2 = norm_param("rmsnorm", d, dtype, device)
        self.moe = RoutedMoE(cfg, generator, dtype, device)

    def _mixer(self, cfg, xn):
        if self.kind == "mamba":
            return ssd_apply(self.ssm, cfg, xn)
        b, s, _ = xn.shape
        q, k, v = qkv_proj(self.attn, xn, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
        out = attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                        scale=cfg.attention_multiplier or None)
        return out.reshape(b, s, -1) @ self.attn["wo"]

    def forward(self, cfg: HybridMoEConfig, x):
        r, eps = cfg.residual_multiplier, cfg.norm_eps
        h = x + r * self._mixer(cfg, rmsnorm(x, self.ln1, eps))
        return h + r * self.moe(cfg, rmsnorm(h, self.ln2, eps))


class HybridMoELM(nn.Module):
    """`embed` (V, D), `blocks` (one `HybridMoEBlock` a layer), `final_norm`."""

    def __init__(self, cfg: HybridMoEConfig, generator: torch.Generator | None = None,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        dev = resolve_device(device)
        if len(cfg.layer_types) < cfg.n_layers:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers but "
                             f"{len(cfg.layer_types)} layer types")
        held = cfg.held
        if held.start < 0 or held.stop > cfg.n_experts or cfg.top_k > cfg.n_experts:
            raise ValueError(f"{cfg.name}: experts {held} or top {cfg.top_k} "
                             f"outside the router's {cfg.n_experts}")
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)
        self.cfg = cfg
        self.embed = nn.Parameter(normal_init((cfg.vocab, cfg.d_model), 0.02,
                                              generator, dtype, dev))
        self.blocks = nn.ModuleList(
            HybridMoEBlock(cfg, cfg.layer_types[i], generator, dtype, dev)
            for i in range(cfg.n_layers))
        self.final_norm = norm_param("rmsnorm", cfg.d_model, dtype, dev)


def forward_hidden(cfg: HybridMoEConfig, lm: HybridMoELM, tokens):
    """The final normed hidden states (B, S, D) of (B, S) `tokens`; each
    layer checkpointed when `cfg.remat` and autograd is on."""
    h = lm.embed[torch.as_tensor(tokens, device=lm.embed.device)] * cfg.embedding_multiplier
    remat = cfg.remat and torch.is_grad_enabled()
    for block in lm.blocks:
        h = checkpoint(block, cfg, h) if remat else block(cfg, h)
    return rmsnorm(h, lm.final_norm, cfg.norm_eps)


def unsupported(cfg, what: str):
    return NotImplementedError(
        f"{cfg.name}: {what} is not supported for the {FAMILY} family, which the "
        f"port runs as a deep-kernel-learning backbone only (the output head and "
        f"the decode caches of its Mamba-2 and attention layers are not built)")
