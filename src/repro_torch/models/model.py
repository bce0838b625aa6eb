"""The LM: embed -> blocks -> final norm -> tied logits (the dense family).

The counterpart of `repro.models.model`. `init_params` returns an
`LM(nn.Module)` holding `embed` (V, D), `blocks` (a `ModuleList` of
`Block`s, one per layer, where the reference stacks layer weights along a
leading L axis) and `final_norm`; the default dtype is bf16 as in the
reference, and deep kernel learning passes fp32. The reference's
`lax.scan` over layers becomes a plain loop, and its per-layer
`jax.checkpoint` (`cfg.remat`) becomes `torch.utils.checkpoint` per block:
the backward keeps each block's input and recomputes its internals.
`_tie_layer_params` is left out: it is a GSPMD scheduling device (it keeps
the compiler from hoisting FSDP all-gathers out of the layer loop) with
bitwise identity, and an eager loop has nothing to hoist.

Cross-entropy is computed in sequence chunks against the tied embedding,
each chunk checkpointed, so the (B, S, V) logits tensor is never resident.

Entry points run on the card unless the caller passes `device="cpu"`:
`init_params` (and `LM`) raise without one. `count_params` builds the LM
on the `meta` device, allocating nothing. Prefill and cached decode, the
encoder stack and the families other than dense wait for ROADMAP A2.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .blocks import Block, check_family
from .config import ArchConfig
from .layers import apply_norm, norm_param, normal_init, positions_for


class LM(nn.Module):
    """Parameters named as the reference's tree: `embed`, `blocks.<i>.*`
    (layer i of the reference's stacked `blocks`), `final_norm`."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator | None = None,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        check_family(cfg)
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)
        self.cfg = cfg
        self.embed = nn.Parameter(normal_init((cfg.vocab, cfg.d_model), 0.02,
                                              generator, dtype, dev))
        self.blocks = nn.ModuleList(Block(cfg, generator, dtype, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = norm_param(cfg.norm, cfg.d_model, dtype, dev)


def init_params(cfg: ArchConfig, generator: torch.Generator | None = None,
                dtype=torch.bfloat16, device=None) -> LM:
    """A randomly initialised LM on `device` (None = the card), drawn from
    `generator` (None = a generator on that device seeded 0)."""
    return LM(cfg, generator, dtype, device)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _run_stack(cfg, blocks, h, positions):
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for block in blocks:
        if remat:
            h, a = checkpoint(block, h, positions, use_reentrant=False)
        else:
            h, a = block(h, positions)
        aux = aux + a
    return h, aux


def forward_hidden(cfg, lm: LM, batch, positions=None):
    """Decoder hidden states (B, S, D) and the MoE aux loss for a
    training/prefill batch ({"tokens": (B, S)}; the modality stubs'
    "embeds" wait for their families), on the LM's device."""
    h = lm.embed[torch.as_tensor(batch["tokens"], device=lm.embed.device)]
    b, s, _ = h.shape
    if positions is None:
        positions = batch.get("positions")
    if positions is None:
        positions = positions_for(cfg, b, s, device=h.device)
    else:
        positions = torch.as_tensor(positions, device=h.device)
    h, aux = _run_stack(cfg, lm.blocks, h, positions)
    return apply_norm(cfg.norm, h, lm.final_norm), aux


# ---------------------------------------------------------------------------
# loss (chunked CE over the tied embedding)
# ---------------------------------------------------------------------------


def _ce_chunk(hx, tx, embed):
    logits = hx.to(torch.float32) @ embed.to(torch.float32).T   # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tx[..., None])[..., 0]
    return torch.sum(lse - gold)


def _chunked_ce(cfg, embed, h, targets):
    """Mean next-token CE without materializing (B, S, V)."""
    b, s, _ = h.shape
    c = min(cfg.ce_chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of ce_chunk {c}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, c):
        hx, tx = h[:, i:i + c], targets[:, i:i + c]
        if torch.is_grad_enabled():
            # checkpointed: the backward otherwise saves every chunk's fp32
            # logits; it recomputes them instead
            total = total + checkpoint(_ce_chunk, hx, tx, embed,
                                       use_reentrant=False)
        else:
            total = total + _ce_chunk(hx, tx, embed)
    return total / (b * s)


def train_loss(cfg: ArchConfig, lm: LM, batch):
    """Mean CE (+ MoE aux) for one batch; metrics dict second."""
    h, aux = forward_hidden(cfg, lm, batch)
    targets = torch.as_tensor(batch["targets"], device=h.device)
    ce = _chunked_ce(cfg, lm.embed, h, targets)
    loss = ce + 0.01 * aux / max(cfg.n_layers, 1)
    return loss, {"ce": ce, "moe_aux": aux}


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------


def count_params(cfg, lm: LM | None = None) -> int:
    if lm is None:
        lm = LM(cfg, device="meta")
    return sum(int(math.prod(p.shape)) for p in lm.parameters())


def count_active_params(cfg) -> int:
    """Per-token active parameters (MoE: top-k + shared only)."""
    total = count_params(cfg)
    if not cfg.n_experts:
        return total
    per_expert = 3 * cfg.d_model * cfg.d_ff
    inactive = cfg.n_layers * (cfg.n_experts - cfg.top_k) * per_expert
    return total - inactive
