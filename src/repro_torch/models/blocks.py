"""Per-family transformer blocks (the counterpart of `repro.models.blocks`).

Families:
  dense / vlm       pre-norm GQA attention + (Sw)iGLU / GeLU MLP
  moe               attention + top-k MoE FFN (+ shared experts)
  ssm               Mamba-2 SSD block (attention-free, no MLP: d_ff = 0)
  hybrid (hymba)    PARALLEL attention + SSM heads on the same normed
                    input, averaged (arXiv:2411.13676), then the MLP; a
                    per-layer window (0 = global attention)
  encdec decoder    self-attention + cross-attention + MLP (seamless); the
                    encoder's blocks are built with family "encdec" and no
                    cross-attention, and run non-causal

`Block.forward(cfg, x, positions, win, enc_out)` is the train / prefill
path and returns (x, moe_aux); `Block.decode(cfg, x, cache, t, win)` is
one cached token at position t and writes the layer's cache in place.
Both take the config from the caller, as the reference's `block_apply`
does, so a caller may override a field that shapes no weight (the MoE
capacity factor).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .attention import attention, attn_params, decode_attention, qkv_proj
from .layers import apply_norm, apply_positional, mlp_apply, mlp_params, norm_param
from .moe import MoE
from .shardctx import (
    axis_index, axis_size, current_mesh, local, shard, shard_heads, spec_of,
)
from .ssd import ssd_apply, ssd_decode_step, ssd_init_state, ssd_params

ATTN_FAMILIES = ("dense", "vlm", "moe", "hybrid", "encdec")
FAMILIES = ATTN_FAMILIES + ("ssm",)


def _tokens(xn):
    """A normed input (B, S, D) before its projections: batch over fsdp,
    sequence and features whole (under a mesh, whatever layout the
    residual add left)."""
    return shard(xn, "fsdp", None, None)


def _attend(q, k, v, *, causal: bool, window: int, chunk: int):
    """`attention` on each rank's shards under a mesh (the identity wrapper
    without one): heads over model where both head counts divide it, else
    the query sequence over model against the full K / V (each rank's
    queries at their absolute offset), else replicated over model."""
    if current_mesh() is None:
        return attention(q, k, v, causal=causal, window=window, chunk=chunk)
    tp = axis_size("model")
    hq, hkv, sq = q.shape[2], k.shape[2], q.shape[1]
    q_offset = 0
    if hq % tp == 0 and hkv % tp == 0:
        qs = kvs = ("fsdp", None, "tp", None)
    elif sq % tp == 0 and sq > 1:
        qs, kvs = ("fsdp", "tp", None, None), ("fsdp", None, None, None)
        q_offset = axis_index("model") * (sq // tp)
    else:
        qs = kvs = ("fsdp", None, None, None)
    return local(lambda q_, k_, v_: attention(
        q_, k_, v_, causal=causal, window=window, chunk=chunk,
        q_offset=q_offset), (q, k, v), (qs, kvs, kvs), qs)


def _decode_attend(q, k_cache, v_cache, t: int, window: int):
    """`decode_attention`, or under a mesh with a DTensor cache, its
    length-sharded form: each rank scores its slots of the cache (masked by
    their absolute positions) and the softmax is combined across the ranks
    that split the length (a max, then sums of the rescaled weights and
    values), as flash-decoding does."""
    if current_mesh() is None or not spec_of(k_cache):   # a plain tensor
        return decode_attention(q, k_cache, v_cache, t, window=window)
    from torch.distributed._functional_collectives import all_reduce

    cspec = spec_of(k_cache)
    batch, length = cspec[0], cspec[1]
    axes = () if length is None else (
        (length,) if isinstance(length, str) else tuple(length))
    dm = k_cache.device_mesh
    s_loc = -(-k_cache.shape[1] // math.prod(dm.size(dm.mesh_dim_names.index(a))
                                             for a in axes))
    offset = s_loc * _linear_coord(axes)
    qspec = (batch, None, None, None)

    def fn(q_, k_, v_):
        b, _, hq, hd = q_.shape
        hkv = k_.shape[2]
        pos = offset + torch.arange(k_.shape[1], device=q_.device)
        ok = pos <= t
        if window > 0:
            ok &= pos > t - window
        qg = q_.reshape(b, hkv, hq // hkv, hd).to(torch.float32)
        sc = torch.einsum("bgrd,bsgd->bgrs", qg, k_.to(torch.float32)) * hd ** -0.5
        sc = sc.masked_fill(~ok, -1e30)
        m = sc.amax(-1, keepdim=True)
        for a in axes:
            m = all_reduce(m, "max", (dm, dm.mesh_dim_names.index(a)))
        w = torch.exp(sc - m)
        den, num = w.sum(-1, keepdim=True), torch.einsum(
            "bgrs,bsgd->bgrd", w, v_.to(torch.float32))
        for a in axes:
            den = all_reduce(den, "sum", (dm, dm.mesh_dim_names.index(a)))
            num = all_reduce(num, "sum", (dm, dm.mesh_dim_names.index(a)))
        return (num / den).reshape(b, 1, hq, hd).to(q_.dtype)

    return local(fn, (q, k_cache, v_cache), (qspec, cspec, cspec), qspec)


def _linear_coord(axes) -> int:
    """This rank's linear index over `axes` (row-major, mesh order)."""
    idx = 0
    for a in axes:
        idx = idx * axis_size(a) + axis_index(a)
    return idx


def _heads_merged(out, b: int, s: int):
    """(B, S, H, hd) -> (B, S, H * hd), the merged heads over model: the
    row-parallel output projection's input layout."""
    return shard(out.reshape(b, s, -1), "fsdp", None, "tp")


class Block(nn.Module):
    """One layer; parameters named as the reference's layer dict (`ln1`,
    `attn.*`, `ln2`, `mlp.*`, `moe.*`, `ssm.*`, `ln_cross`, `cross.*`)."""

    def __init__(self, cfg, generator, dtype, device, *, cross: bool = False):
        super().__init__()
        fam = cfg.family
        if fam not in FAMILIES:
            raise ValueError(f"{cfg.name}: unknown family {fam!r}; "
                             f"options: {FAMILIES}")
        d = cfg.d_model
        self.ln1 = norm_param(cfg.norm, d, dtype, device)
        if fam in ATTN_FAMILIES:
            self.attn = attn_params(generator, d, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.hd, dtype, device)
        if fam == "moe":
            self.ln2 = norm_param(cfg.norm, d, dtype, device)
            self.moe = MoE(generator, d, cfg.d_ff, cfg.n_experts,
                           cfg.n_shared_experts, dtype, device)
        elif fam != "ssm":
            self.ln2 = norm_param(cfg.norm, d, dtype, device)
            self.mlp = mlp_params(cfg.mlp, generator, d, cfg.d_ff, dtype, device)
        if fam in ("ssm", "hybrid"):
            self.ssm = ssd_params(generator, cfg, dtype, device)
        if cross:
            self.ln_cross = norm_param(cfg.norm, d, dtype, device)
            self.cross = attn_params(generator, d, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.hd, dtype, device)

    # -- train / prefill ----------------------------------------------------

    def _attn_branch(self, cfg, xn, positions, win, causal):
        q, k, v = qkv_proj(self.attn, xn, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
        q = shard_heads(apply_positional(cfg, q, positions))
        k = apply_positional(cfg, k, positions)
        out = _attend(q, k, v, causal=causal, window=win, chunk=cfg.attn_chunk)
        b, s = xn.shape[:2]
        return _heads_merged(out, b, s) @ self.attn["wo"]

    def _ffn(self, cfg, x, capacity_factor):
        """The pre-norm FFN residual: (x, moe_aux)."""
        if cfg.family == "ssm":
            return x, None
        xn = _tokens(apply_norm(cfg.norm, x, self.ln2))
        if cfg.family == "moe":
            mo, aux = self.moe(xn, top_k=cfg.top_k, capacity_factor=capacity_factor)
            return x + mo, aux
        return x + mlp_apply(cfg.mlp, self.mlp, xn), None

    def forward(self, cfg, x, positions, win: int = 0, enc_out=None, *,
                causal: bool = True):
        """One block, training / prefill. Returns (x, moe_aux)."""
        xn = _tokens(apply_norm(cfg.norm, x, self.ln1))
        fam = cfg.family
        if fam == "hybrid":
            attn_out = self._attn_branch(cfg, xn, positions, win, True)
            ssm_out = ssd_apply(self.ssm, cfg, xn)
            x = x + 0.5 * (attn_out + ssm_out)
        elif fam == "ssm":
            x = x + ssd_apply(self.ssm, cfg, xn)
        else:
            x = x + self._attn_branch(cfg, xn, positions, win, causal)

        if enc_out is not None:  # cross-attention (enc-dec decoder)
            xn = _tokens(apply_norm(cfg.norm, x, self.ln_cross))
            b, s = xn.shape[:2]
            se = enc_out.shape[1]
            q = (xn @ self.cross["wq"]).reshape(b, s, cfg.n_heads, cfg.hd)
            k = (enc_out @ self.cross["wk"]).reshape(b, se, cfg.n_kv_heads, cfg.hd)
            v = (enc_out @ self.cross["wv"]).reshape(b, se, cfg.n_kv_heads, cfg.hd)
            out = _attend(q, k, v, causal=False, window=0, chunk=cfg.attn_chunk)
            x = x + _heads_merged(out, b, s) @ self.cross["wo"]

        x, aux = self._ffn(cfg, x, cfg.capacity_factor)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, aux

    # -- cached decode ------------------------------------------------------

    def _attn_decode_branch(self, cfg, xn, cache, t: int, win: int):
        b = xn.shape[0]
        q, k, v = qkv_proj(self.attn, xn, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
        pos = torch.full((b, 1), t, dtype=torch.int32, device=xn.device)
        if cfg.mrope_sections:
            pos = pos[None].expand(3, b, 1)
        q = apply_positional(cfg, q, pos)
        k = apply_positional(cfg, k, pos)
        cache["k"][:, t] = k[:, 0]
        cache["v"][:, t] = v[:, 0]
        out = _decode_attend(q, cache["k"], cache["v"], t, win)
        return out.reshape(b, 1, -1) @ self.attn["wo"]

    def decode(self, cfg, x, cache, t: int, win: int = 0):
        """One block, one new token x (B, 1, D) at position t (a host int).
        Writes the layer's `cache` in place; returns x."""
        xn = apply_norm(cfg.norm, x, self.ln1)
        fam = cfg.family
        if fam == "hybrid":
            a_out = self._attn_decode_branch(cfg, xn, cache, t, win)
            s_out, _ = ssd_decode_step(self.ssm, cfg, cache["ssm"], xn)
            x = x + 0.5 * (a_out + s_out)
        elif fam == "ssm":
            s_out, _ = ssd_decode_step(self.ssm, cfg, cache["ssm"], xn)
            x = x + s_out
        else:
            x = x + self._attn_decode_branch(cfg, xn, cache, t, win)

        if "ck" in cache:  # cross-attention against the encoder's K/V
            xn = apply_norm(cfg.norm, x, self.ln_cross)
            b = xn.shape[0]
            q = (xn @ self.cross["wq"]).reshape(b, 1, cfg.n_heads, cfg.hd)
            out = _decode_attend(q, cache["ck"], cache["cv"],
                                 cache["ck"].shape[1] - 1, 0)
            x = x + out.reshape(b, 1, -1) @ self.cross["wo"]

        # MoE at capacity factor 8: one token per sequence never drops
        x, _ = self._ffn(cfg, x, 8.0)
        return x


def init_layer_cache(cfg, batch: int, max_seq: int, dtype, device=None,
                     *, enc_len: int = 0) -> dict:
    """The cache of ONE layer: `k` / `v` (B, max_seq, Hkv, hd) for the
    attention families, `ssm` ({"conv", "ssm"}) for ssm and hybrid, and
    `ck` / `cv` (B, enc_len, Hkv, hd) for an enc-dec decoder."""
    c = {}
    kv = (batch, max_seq, cfg.n_kv_heads, cfg.hd)
    if cfg.family in ATTN_FAMILIES:
        c["k"] = torch.zeros(kv, dtype=dtype, device=device)
        c["v"] = torch.zeros(kv, dtype=dtype, device=device)
    if cfg.family in ("ssm", "hybrid"):
        c["ssm"] = ssd_init_state(cfg, batch, dtype, device)
    if enc_len:
        ckv = (batch, enc_len, cfg.n_kv_heads, cfg.hd)
        c["ck"] = torch.zeros(ckv, dtype=dtype, device=device)
        c["cv"] = torch.zeros(ckv, dtype=dtype, device=device)
    return c
