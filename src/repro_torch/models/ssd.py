"""Mamba-2 SSD (state-space duality) block: chunked scan and O(1) decode.

The counterpart of `repro.models.ssd` (arXiv:2405.21060 §6). The sequence
is processed in chunks of `ssm_chunk`: within a chunk the output is the
masked-decay "attention" form, across chunks a recurrent state
(B, H, P, N) is carried; the reference's `lax.scan` over chunks is a
Python loop here. Per-head scalar decay a_t = exp(-exp(A_log) * dt_t), one
B/C group, a gated RMSNorm before the output projection (eps: the
config's `norm_eps` where it has one, else 1e-6), a depthwise
causal conv on (x, B, C), softplus dt with a bias, and the D skip.

`A_log`, `dt_bias` and `D` are fp32 whatever the model's dtype, and so are
the scan's decays and state. The reference's `runtime_flags.materialize`
calls are left out: they are scheduling barriers that keep XLA from
recomputing a fused chain inside every consumer, with identity values, and
eager PyTorch materializes every intermediate anyway.

Decode is the recurrence h <- a h + dt x (x) B; y = C . h + D x, with a
(kernel - 1)-deep conv state, updated in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device

from .layers import normal_init, rmsnorm
from .shardctx import current_mesh, local


def ssd_params(generator, cfg, dtype, device=None) -> nn.ParameterDict:
    device = resolve_device(device)
    d, dinner, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = dinner + 2 * n
    f32 = torch.float32
    return nn.ParameterDict({
        # order: [z | x | B | C | dt]
        "in_proj": normal_init((d, 2 * dinner + 2 * n + h), (2.0 / d) ** 0.5,
                               generator, dtype, device),
        "conv_w": normal_init((cfg.conv_kernel, conv_dim), 0.1, generator,
                              dtype, device),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32, device=device)),
        "dt_bias": torch.full((h,), 0.5, dtype=f32, device=device),
        "D": torch.ones((h,), dtype=f32, device=device),
        "norm_scale": torch.ones((dinner,), dtype=dtype, device=device),
        "out_proj": normal_init((dinner, d), (2.0 / dinner) ** 0.5, generator,
                                dtype, device),
    })


def _split_proj(cfg, proj):
    dinner, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z = proj[..., :dinner]
    xbc = proj[..., dinner:dinner + dinner + 2 * n]
    dt = proj[..., -h:]
    return z, xbc, dt


def _causal_conv(xbc, w, b):
    """Depthwise causal conv over the seq axis. xbc (B, S, C); w (K, C)."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1]] * w[i] for i in range(k))
    return F.silu(out + b)


def _chunk_step(Hstate, xc, Bc, Cc, dtc, lac, carry: bool = True):
    """One chunk: its outputs (B, q, H, P) and, with `carry`, the state
    after it (else None). Hstate None is the zero state: the first chunk
    reads no state and the last forms none (a sequence of one chunk forms
    no (B, H, P, N) state at all); the outputs are the same."""
    q = xc.shape[1]
    # intra-chunk "attention": L[q, k] = exp(la_q - la_k) for q >= k
    Gm = torch.einsum("bqn,bkn->bqk", Cc, Bc)
    ldiff = lac[:, :, None, :] - lac[:, None, :, :]          # (B, q, k, H)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=xc.device))[None, :, :, None]
    # clamp BEFORE exp: masked (upper-triangle) entries have ldiff > 0 and
    # would overflow, and the backward would meet 0 * inf = NaN
    Ld = torch.where(mask, torch.exp(torch.where(mask, ldiff, 0.0)), 0.0)
    dtx = xc * dtc[..., None]                                # (B, q, H, P)
    GL = Gm[:, :, :, None] * Ld                              # (B, q, k, H)
    y = torch.einsum("bqkh,bkhp->bqhp", GL, dtx)
    if Hstate is not None:
        # inter-chunk contribution from the carried state
        y_in = torch.einsum("bqn,bhpn->bqhp", Cc, Hstate)
        y = y + y_in * torch.exp(lac)[..., None]
    if not carry:
        return None, y
    # chunk state update
    la_end = lac[:, -1:, :]                                  # (B, 1, H)
    dtxd = dtx * torch.exp(la_end - lac)[..., None]          # (B, q, H, P)
    Snew = torch.einsum("bkn,bkhp->bhpn", Bc, dtxd)
    if Hstate is None:
        return Snew, y
    return torch.exp(la_end[:, 0, :])[..., None, None] * Hstate + Snew, y


def ssd_apply(p, cfg, x):
    """x (B, S, D) -> (B, S, D) via the chunked SSD. Under a mesh, on each
    rank's batch shard with the block's weights replicated (the scan is
    per sequence)."""
    if current_mesh() is None:
        return _ssd_apply(p, cfg, x)
    names = list(p.keys())
    ws = [p[k] for k in names]
    tok = ("fsdp", None, None)
    return local(lambda x_, *ws_: _ssd_apply(dict(zip(names, ws_)), cfg, x_),
                 (x, *ws), (tok, *((None,) * w.ndim for w in ws)), tok)


def _ssd_apply(p, cfg, x):
    bsz, s_orig, _ = x.shape
    dinner, n, h, pdim = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    q = min(cfg.ssm_chunk, s_orig)
    pad = (-s_orig) % q
    if pad:  # causal: a trailing zero-pad never affects earlier outputs
        x = F.pad(x, (0, 0, 0, pad))
    s = x.shape[1]

    proj = x @ p["in_proj"]
    z, xbc, dt = _split_proj(cfg, proj)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., :dinner].reshape(bsz, s, h, pdim)
    Bm = xbc[..., dinner:dinner + n]                         # (B, S, N)
    Cm = xbc[..., dinner + n:]                               # (B, S, N)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])     # (B, S, H)
    a_log = -torch.exp(p["A_log"]) * dt                      # log a_t (B, S, H)

    nc = s // q
    xs_c = xs.reshape(bsz, nc, q, h, pdim).to(torch.float32)
    B_c = Bm.reshape(bsz, nc, q, n).to(torch.float32)
    C_c = Cm.reshape(bsz, nc, q, n).to(torch.float32)
    dt_c = dt.reshape(bsz, nc, q, h)
    la_c = torch.cumsum(a_log.reshape(bsz, nc, q, h), dim=2)  # within-chunk

    Hstate = None
    ys = []
    for c in range(nc):
        Hstate, y = _chunk_step(Hstate, xs_c[:, c], B_c[:, c], C_c[:, c],
                                dt_c[:, c], la_c[:, c], carry=c < nc - 1)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(bsz, s, h, pdim)
    y = y + p["D"][None, None, :, None] * xs.to(torch.float32)
    y = y.reshape(bsz, s, dinner).to(x.dtype)
    # gated RMSNorm (mamba2), then the output projection
    y = rmsnorm(y * F.silu(z), p["norm_scale"], getattr(cfg, "norm_eps", 1e-6))
    return (y @ p["out_proj"])[:, :s_orig]


# ---------------------------------------------------------------------------
# decode path: O(1) recurrent update
# ---------------------------------------------------------------------------


def ssd_init_state(cfg, batch: int, dtype, device=None) -> dict:
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1,
                             cfg.d_inner + 2 * cfg.ssm_state),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state), dtype=torch.float32, device=device),
    }


def ssd_decode_step(p, cfg, state, x):
    """x (B, 1, D) -> (y (B, 1, D), state): `state` is updated in place
    (its tensors keep their storage) and returned."""
    bsz = x.shape[0]
    dinner, n, h, pdim = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    proj = x[:, 0] @ p["in_proj"]
    z, xbc, dt = _split_proj(cfg, proj)
    # conv over the rolled state
    hist = torch.cat([state["conv"], xbc[:, None].to(state["conv"].dtype)], dim=1)
    conv = torch.einsum("bkc,kc->bc", hist, p["conv_w"]) + p["conv_b"]
    xbc = F.silu(conv)
    state["conv"].copy_(hist[:, 1:])

    xs = xbc[:, :dinner].reshape(bsz, h, pdim).to(torch.float32)
    Bm = xbc[:, dinner:dinner + n].to(torch.float32)
    Cm = xbc[:, dinner + n:].to(torch.float32)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])     # (B, H)
    a = torch.exp(-torch.exp(p["A_log"]) * dt)               # (B, H)

    Hs = state["ssm"] * a[..., None, None] + torch.einsum(
        "bhp,bn,bh->bhpn", xs, Bm, dt)
    y = torch.einsum("bn,bhpn->bhp", Cm, Hs) + p["D"][None, :, None] * xs
    state["ssm"].copy_(Hs)
    y = y.reshape(bsz, dinner).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm_scale"])
    return (y @ p["out_proj"])[:, None], state
