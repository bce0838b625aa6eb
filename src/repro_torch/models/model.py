"""The LM: embed -> blocks -> final norm -> tied logits, for every family.

The counterpart of `repro.models.model`. `init_params` returns an
`LM(nn.Module)` holding `embed` (V, D), `blocks` (a `ModuleList` of
`Block`s, one per layer, where the reference stacks layer weights along a
leading L axis), `final_norm`, and for the enc-dec family `enc_blocks` and
`enc_norm`; the default dtype is bf16 as in the reference. The reference's
`lax.scan` over layers becomes a plain loop, and its per-layer
`jax.checkpoint` (`cfg.remat`) becomes `torch.utils.checkpoint` per block
(`shardctx.checkpoint`: the recompute runs under the forward's mesh): the
backward keeps each block's input and recomputes its internals.
`_tie_layer_params` is left out: it is a GSPMD scheduling device (it keeps
the compiler from hoisting FSDP all-gathers out of the layer loop) with
bitwise identity, and an eager loop has nothing to hoist.

Cross-entropy is computed in sequence chunks against the tied embedding,
each chunk checkpointed, so the (B, S, V) logits tensor is never resident.

Serving: `init_decode_state` allocates every layer's cache once, `prefill`
runs the prompt and writes the caches, `decode_step` runs one token and
writes one slot per layer. Caches are written in place (their tensors keep
their storage), and the position `t` is a host int, so the decode loop
never reads the card.

Modality stubs: a batch may carry precomputed frame / patch embeddings;
`embeds` alone replaces the tokens (audio), and with `embed_mask` it
overrides the masked positions of the token embedding (vlm).

A port-only family with its own config type and module
(`models/hybrid_moe.py`, granitemoehybrid) goes through the same entry
points: `init_params`, `forward_hidden` and `count_params` dispatch on
its config; `train_loss`, `init_decode_state`, `prefill` and
`decode_step` raise NotImplementedError for it.

Entry points run on the card unless the caller passes `device="cpu"`:
`init_params` (and `LM`) and `init_decode_state` raise without one.
`count_params` builds the LM on the `meta` device, allocating nothing.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .attention import qkv_proj
from .blocks import Block, init_layer_cache
from . import hybrid_moe
from .config import ArchConfig
from .layers import apply_norm, apply_positional, norm_param, normal_init, positions_for
from .shardctx import checkpoint, shard, shard_hidden
from .ssd import _causal_conv, _split_proj


class LM(nn.Module):
    """Parameters named as the reference's tree: `embed`, `blocks.<i>.*`
    (layer i of the reference's stacked `blocks`), `final_norm`, and
    `enc_blocks.<i>.*`, `enc_norm` for an enc-dec config."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator | None = None,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)
        self.cfg = cfg
        self.embed = nn.Parameter(normal_init((cfg.vocab, cfg.d_model), 0.02,
                                              generator, dtype, dev))
        self.blocks = nn.ModuleList(
            Block(cfg, generator, dtype, dev, cross=cfg.is_encdec)
            for _ in range(cfg.n_layers))
        self.final_norm = norm_param(cfg.norm, cfg.d_model, dtype, dev)
        if cfg.is_encdec:
            enc_cfg = cfg._replace(family="encdec")
            self.enc_blocks = nn.ModuleList(
                Block(enc_cfg, generator, dtype, dev)
                for _ in range(cfg.n_enc_layers))
            self.enc_norm = norm_param(cfg.norm, cfg.d_model, dtype, dev)


def init_params(cfg: ArchConfig, generator: torch.Generator | None = None,
                dtype=torch.bfloat16, device=None) -> LM:
    """A randomly initialised LM on `device` (None = the card), drawn from
    `generator` (None = a generator on that device seeded 0)."""
    if hybrid_moe.is_hybrid_moe(cfg):
        return hybrid_moe.HybridMoELM(cfg, generator, dtype, device)
    return LM(cfg, generator, dtype, device)


def _win_schedule(cfg) -> tuple:
    """Per-layer window sizes (0 = full attention)."""
    if not cfg.sliding_window:
        return (0,) * cfg.n_layers
    return tuple(0 if i in cfg.global_layers else cfg.sliding_window
                 for i in range(cfg.n_layers))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _embed_input(cfg, lm: LM, batch):
    """tokens / embeds -> (B, S, D) input activations on the LM's device."""
    dev = lm.embed.device
    if "embeds" in batch and "tokens" not in batch:
        return torch.as_tensor(batch["embeds"], device=dev).to(lm.embed.dtype)
    h = lm.embed[torch.as_tensor(batch["tokens"], device=dev)]
    if "embeds" in batch:  # vlm: patch embeddings override masked positions
        mask = torch.as_tensor(batch["embed_mask"], device=dev)[..., None]
        embeds = torch.as_tensor(batch["embeds"], device=dev).to(h.dtype)
        h = torch.where(mask, embeds, h)
    return h


def _run_stack(cfg, blocks, h, positions, wins, enc_out=None, *, causal=True):
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = cfg.remat and torch.is_grad_enabled()
    # the residual stream between blocks: batch over fsdp. Not sequence-
    # parallel as the reference's: DTensor cannot carry a sequence shard
    # through the flattened (B * S) matmuls of the backward
    h = shard_hidden(h, sp=False)
    for block, win in zip(blocks, wins):
        if remat:
            h, a = checkpoint(block, cfg, h, positions, win, enc_out,
                              causal=causal)
        else:
            h, a = block(cfg, h, positions, win, enc_out, causal=causal)
        h = shard_hidden(h, sp=False)
        aux = aux + a
    return h, aux


def encode(cfg, lm: LM, enc_embeds):
    """Encoder stack (seamless): full self-attention, no cache."""
    x = torch.as_tensor(enc_embeds, device=lm.embed.device).to(lm.embed.dtype)
    b, s, _ = x.shape
    pos = positions_for(cfg, b, s, device=x.device)
    h, _ = _run_stack(cfg._replace(family="encdec"), lm.enc_blocks, x, pos,
                      (0,) * cfg.n_enc_layers, causal=False)
    return apply_norm(cfg.norm, h, lm.enc_norm)


def forward_hidden(cfg, lm: LM, batch, positions=None):
    """Decoder hidden states (B, S, D) and the summed MoE aux loss for a
    training / prefill batch, on the LM's device (granitemoehybrid: its
    tokens alone, and an aux loss of 0, which the family leaves out)."""
    if hybrid_moe.is_hybrid_moe(cfg):
        h = hybrid_moe.forward_hidden(cfg, lm, batch["tokens"])
        return h, torch.zeros((), dtype=torch.float32, device=h.device)
    h = _embed_input(cfg, lm, batch)
    b, s, _ = h.shape
    if positions is None:
        positions = batch.get("positions")
    if positions is None:
        positions = positions_for(cfg, b, s, device=h.device)
    else:
        positions = torch.as_tensor(positions, device=h.device)
    enc_out = encode(cfg, lm, batch["enc_embeds"]) if cfg.is_encdec else None
    h, aux = _run_stack(cfg, lm.blocks, h, positions, _win_schedule(cfg), enc_out)
    return apply_norm(cfg.norm, h, lm.final_norm), aux


# ---------------------------------------------------------------------------
# loss (chunked CE over the tied embedding)
# ---------------------------------------------------------------------------


def _ce_chunk(hx, tx, embed):
    h32, e32 = hx.to(torch.float32), embed.to(torch.float32)
    logits = shard(h32 @ e32.T, "fsdp", None, "tp")             # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    # the gold logit as a row-wise dot with the target's embedding row: the
    # same value as a gather from `logits`, and no index into a V-sharded
    # tensor under DTensor
    gold = torch.sum(h32 * e32[tx], dim=-1)
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
            total = total + checkpoint(_ce_chunk, hx, tx, embed)
        else:
            total = total + _ce_chunk(hx, tx, embed)
    return total / (b * s)


def train_loss(cfg: ArchConfig, lm: LM, batch):
    """Mean CE (+ MoE aux) for one batch; metrics dict second."""
    if hybrid_moe.is_hybrid_moe(cfg):
        raise hybrid_moe.unsupported(cfg, "train_loss")
    h, aux = forward_hidden(cfg, lm, batch)
    targets = torch.as_tensor(batch["targets"], device=h.device)
    ce = _chunked_ce(cfg, lm.embed, h, targets)
    loss = ce + 0.01 * aux / max(cfg.n_layers, 1)
    return loss, {"ce": ce, "moe_aux": aux}


# ---------------------------------------------------------------------------
# serving: prefill + cached decode
# ---------------------------------------------------------------------------


def _logits(lm: LM, h):
    return h.to(torch.float32) @ lm.embed.to(torch.float32).T


def init_decode_state(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
                      *, enc_len: int = 0, device=None) -> dict:
    """{"caches": one `init_layer_cache` dict per layer, "t": 0} on `device`
    (None = the card)."""
    if hybrid_moe.is_hybrid_moe(cfg):
        raise hybrid_moe.unsupported(cfg, "decoding")
    dev = resolve_device(device)
    return {"caches": [init_layer_cache(cfg, batch, max_seq, dtype, dev,
                                        enc_len=enc_len)
                       for _ in range(cfg.n_layers)],
            "t": 0}


def _ssd_prefill_state(cfg, p, xn, ssm_cache):
    """Write into `ssm_cache` the recurrent and conv state after the prompt
    xn (B, S, D): the conv state is the last kernel - 1 inputs of the
    conv, the recurrent state the decayed sum over the whole prompt, fp32."""
    b, s, _ = xn.shape
    proj = xn @ p["in_proj"]
    _, xbc, dt = _split_proj(cfg, proj)
    conv_tail = xbc[:, -(cfg.conv_kernel - 1):]
    xbc_f = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    dinner, n, hh, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    xs = xbc_f[..., :dinner].reshape(b, s, hh, pd).to(torch.float32)
    Bm = xbc_f[..., dinner:dinner + n].to(torch.float32)
    dtv = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    la = torch.cumsum(-torch.exp(p["A_log"]) * dtv, dim=1)    # (B, S, H)
    decay_to_end = torch.exp(la[:, -1:, :] - la)
    w = xs * (dtv * decay_to_end)[..., None]                 # (B, S, H, P)
    ssm_cache["conv"].copy_(conv_tail)
    ssm_cache["ssm"].copy_(torch.einsum("bkn,bkhp->bhpn", Bm, w))


@torch.no_grad()
def prefill(cfg, lm: LM, state, batch):
    """Run the prompt, fill the caches in place; (state, last-token logits
    (B, V) fp32).

    As the reference: the training forward plus cache writes, each layer's
    K/V recomputed from its normed input into slots [0, S) of the cache;
    for ssm / hybrid the final SSD state seeds the recurrence."""
    if hybrid_moe.is_hybrid_moe(cfg):
        raise hybrid_moe.unsupported(cfg, "prefill")
    h = shard_hidden(_embed_input(cfg, lm, batch), sp=False)
    b, s, _ = h.shape
    positions = positions_for(cfg, b, s, device=h.device)
    enc_out = encode(cfg, lm, batch["enc_embeds"]) if cfg.is_encdec else None
    for block, win, cache in zip(lm.blocks, _win_schedule(cfg), state["caches"]):
        xn = shard(apply_norm(cfg.norm, h, block.ln1), "fsdp", None, None)
        if "k" in cache:
            _, k, v = qkv_proj(block.attn, xn, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
            cache["k"][:, :s] = apply_positional(cfg, k, positions)
            cache["v"][:, :s] = v
        if "ck" in cache:
            se = enc_out.shape[1]
            shape = (b, se, cfg.n_kv_heads, cfg.hd)
            cache["ck"].copy_((enc_out @ block.cross["wk"]).reshape(shape))
            cache["cv"].copy_((enc_out @ block.cross["wv"]).reshape(shape))
        if "ssm" in cache:
            _ssd_prefill_state(cfg, block.ssm, xn, cache["ssm"])
        h, _ = block(cfg, h, positions, win, enc_out)
        h = shard_hidden(h, sp=False)
    h = apply_norm(cfg.norm, h, lm.final_norm)
    state["t"] = s
    return state, _logits(lm, h[:, -1])


@torch.no_grad()
def decode_step(cfg, lm: LM, state, token_or_embed):
    """One decode step at position state["t"]: token_or_embed is (B,) int
    tokens or (B, 1, D) embeddings. Writes the caches in place, advances
    state["t"] (a host int); (state, logits (B, V) fp32)."""
    if hybrid_moe.is_hybrid_moe(cfg):
        raise hybrid_moe.unsupported(cfg, "decoding")
    x = torch.as_tensor(token_or_embed, device=lm.embed.device)
    if x.ndim == 1:
        x = lm.embed[x][:, None]
    else:
        x = x.to(lm.embed.dtype)
    t = state["t"]
    for block, win, cache in zip(lm.blocks, _win_schedule(cfg), state["caches"]):
        x = block.decode(cfg, x, cache, t, win)
    x = apply_norm(cfg.norm, x, lm.final_norm)
    state["t"] = t + 1
    return state, _logits(lm, x[:, 0])


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------


def count_params(cfg, lm: LM | None = None) -> int:
    if lm is None:
        lm = init_params(cfg, device="meta")
    return sum(int(math.prod(p.shape)) for p in lm.parameters())


def count_active_params(cfg) -> int:
    """Per-token active parameters (MoE: top-k + shared only; of a
    granitemoehybrid config holding a share of the experts, the share's)."""
    total = count_params(cfg)
    if not cfg.n_experts:
        return total
    if hybrid_moe.is_hybrid_moe(cfg):
        per_expert = 3 * cfg.d_model * cfg.d_ff
        return total - cfg.n_layers * max(len(cfg.held) - cfg.top_k, 0) * per_expert
    per_expert = 3 * cfg.d_model * cfg.d_ff
    inactive = cfg.n_layers * (cfg.n_experts - cfg.top_k) * per_expert
    return total - inactive
