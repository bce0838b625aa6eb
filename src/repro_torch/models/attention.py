"""GQA attention: the query-chunked training/prefill path and cached decode.

The counterpart of `repro.models.attention`, computed as the reference
computes it (no fused attention call, so parity holds at the fp32
conformance tolerances). Queries are processed in `attn_chunk` blocks
against the full K/V: the softmax per block is exact, K being fully
resident, and the peak score memory is (B, H, attn_chunk, S) instead of
(B, H, S, S). Scores and softmax are fp32; masked entries take -1e30.
Each chunk is checkpointed under autograd, so the backward recomputes a
chunk's probabilities instead of keeping every chunk's resident.

Masks: causal, causal + sliding window (window > 0), or none (encoder,
cross-attention). Decode (`decode_attention`) attends one new token
against the KV cache.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device

from .layers import normal_init
from .shardctx import checkpoint


def _repeat_kv(k, n_rep: int):
    """(B, S, Hkv, hd) -> (B, S, Hkv * n_rep, hd): each KV head repeated
    n_rep times consecutively (head h serves queries h * n_rep ...)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def attention(q, k, v, *, causal: bool, window: int = 0, chunk: int = 1024,
              q_offset: int = 0, scale: float | None = None):
    """q (B, Sq, Hq, hd); k/v (B, Sk, Hkv, hd) -> (B, Sq, Hq, hd).

    window > 0 adds a sliding-window constraint (keys within `window` of
    the query). q_offset is the absolute position of q[0]. `scale`
    multiplies the scores (None = hd ** -0.5).
    """
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    k = _repeat_kv(k, hq // hkv)
    v = _repeat_kv(v, hq // hkv)
    scale = hd ** -0.5 if scale is None else scale
    chunk = min(chunk, sq)
    pad = (-sq) % chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
    nchunks = q.shape[1] // chunk
    qc = q.reshape(b, nchunks, chunk, hq, hd).permute(1, 0, 3, 2, 4)

    kT = k.permute(0, 2, 3, 1).to(torch.float32)     # (B, H, hd, Sk)
    vT = v.permute(0, 2, 1, 3).to(torch.float32)     # (B, H, Sk, hd)
    kpos = torch.arange(sk, device=q.device)

    def one_chunk(ci: int, qb):
        # qb: (B, H, chunk, hd)
        scores = torch.matmul(qb.to(torch.float32), kT) * scale
        qpos = q_offset + ci * chunk + torch.arange(chunk, device=q.device)
        mask = torch.ones((chunk, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
        scores = scores.masked_fill(~mask, -1e30)
        probs = torch.softmax(scores, dim=-1)
        return torch.matmul(probs, vT).to(q.dtype)

    if nchunks == 1:
        out = one_chunk(0, qc[0])[None]
    elif torch.is_grad_enabled():
        out = torch.stack([checkpoint(one_chunk, ci, qc[ci])
                           for ci in range(nchunks)])
    else:
        out = torch.stack([one_chunk(ci, qc[ci]) for ci in range(nchunks)])
    out = out.permute(1, 0, 3, 2, 4).reshape(b, nchunks * chunk, hq, hd)
    return out[:, :sq]


def decode_attention(q, k_cache, v_cache, t: int, *, window: int = 0):
    """One-token decode: q (B, 1, Hq, hd) vs cache (B, S, Hkv, hd).

    `t` (a host int) is the position of the new token, already written to
    slot t: slots after t are masked, and with window > 0 so are slots
    <= t - window. A masked slot would take -1e30 and a softmax weight of
    exactly 0, so only the slots that take part, [lo, t], are read: the
    work per token grows with t, not with the cache's length. Scores and
    softmax are fp32. Each KV head serves its Hq / Hkv consecutive query
    heads (as `_repeat_kv`), grouped here so the cache is never repeated.
    """
    b, _, hq, hd = q.shape
    hkv = k_cache.shape[2]
    lo = max(t - window + 1, 0) if window > 0 else 0
    k = k_cache[:, lo:t + 1].to(torch.float32)            # (B, s, Hkv, hd)
    v = v_cache[:, lo:t + 1].to(torch.float32)
    qg = q.reshape(b, hkv, hq // hkv, hd).to(torch.float32)
    scores = torch.einsum("bgrd,bsgd->bgrs", qg, k) * hd ** -0.5
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", probs, v)
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def attn_params(generator, d: int, hq: int, hkv: int, hd: int, dtype,
                device=None) -> nn.ParameterDict:
    device = resolve_device(device)
    s = (2.0 / d) ** 0.5
    so = (2.0 / (hq * hd)) ** 0.5
    return nn.ParameterDict({
        "wq": normal_init((d, hq * hd), s, generator, dtype, device),
        "wk": normal_init((d, hkv * hd), s, generator, dtype, device),
        "wv": normal_init((d, hkv * hd), s, generator, dtype, device),
        "wo": normal_init((hq * hd, d), so, generator, dtype, device),
    })


def qkv_proj(p, x, hq: int, hkv: int, hd: int):
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, hq, hd)
    k = (x @ p["wk"]).reshape(b, s, hkv, hd)
    v = (x @ p["wv"]).reshape(b, s, hkv, hd)
    return q, k, v
