"""Plain reference of the granitemoehybrid backbone (IBM Granite 4.0-H) as
a deep-kernel-learning feature extractor, and the Eq. 2 X gradient of a
Matern-3/2 GP head.

Plain `torch` in float32 with TF32 off (`exact_fp32`), no kernel, no cache
and no micro-batching; gradients come from autograd. It imports nothing of
the program. The configuration is a dict with the keys of the model's
config.json (`hidden_size`, `layer_types`, `mamba_d_state`, ...) and two of
its own for the experts held: `router_experts`, the router's width, and
`expert_offset`, the first held expert; `num_local_experts` counts the
experts held. The weights are a dict of float32 tensors in (in, out) layout
(`x @ W`) under these names, i the layer:

    embed (V, D), final_norm (D,)
    blocks.i.ln1, blocks.i.ln2 (D,)
    blocks.i.ssm.in_proj (D, 2 Di + 2 N + H)   columns [z | x | B | C | dt]
    blocks.i.ssm.conv_w (K, Di + 2 N), conv_b (Di + 2 N,)
    blocks.i.ssm.A_log, dt_bias, D (H,), norm_scale (Di,), out_proj (Di, D)
    blocks.i.attn.wq (D, Hq hd), wk, wv (D, Hkv hd), wo (Hq hd, D)
    blocks.i.moe.router (D, router_experts)
    blocks.i.moe.wi, wg (held, D, F), wo (held, F, D)
    blocks.i.moe.shared.wi, wg (D, Fs), wo (Fs, D)

A layer, with r the residual multiplier:

    h  = x + r * Mixer(RMSNorm(x))
    x' = h + r * (Shared(RMSNorm(h)) + sum_e g_e Expert_e(RMSNorm(h)))

The Mamba-2 mixer follows its published recurrence, h_t = exp(dt_t A) h_{t-1}
+ dt_t x_t B_t^T, y_t = h_t C_t + D x_t, after a causal depthwise conv (with
bias) and SiLU on (x, B, C), dt = softplus(dt + dt_bias), A = -exp(A_log);
then the gated RMSNorm of y * SiLU(z) over the whole inner width (one
group), and the output projection. `form="quadratic"` computes the same
outputs by the recurrence's closed form over the sequence, y_t = sum_{s<=t}
(C_t . B_s) exp(sum_{s<r<=t} dt_r A) dt_s x_s + D x_t, whose autograd keeps
(B, S, S, H) instead of a (B, H, P, N) state a step. Attention is causal
GQA with no positional encoding, scores times `attention_multiplier`. The
router takes the top `num_experts_per_tok` of its fp32 logits and
normalises them by a softmax over those; the gates form a dense (tokens,
router_experts) matrix, zero off the top k, and every held expert runs on
every token, weighted by its column. Embedding rows are scaled by
`embedding_multiplier`. The features are the mean over the sequence of the
final RMSNorm's output.

Departures, as in the program: no router auxiliary loss, no output head.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def exact_fp32():
    """float32 matmuls in IEEE fp32 (no TF32) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def swiglu(x, wg, wi, wo):
    return (F.silu(x @ wg) * (x @ wi)) @ wo


def mamba2(W: dict, cfg: dict, x, form: str = "recurrent"):
    """The Mamba-2 mixer of x (B, S, D) with the layer's weights W (names
    without the `blocks.i.ssm.` prefix)."""
    b, s, _ = x.shape
    di = cfg["mamba_expand"] * cfg["hidden_size"]
    n, h, p = cfg["mamba_d_state"], cfg["mamba_n_heads"], cfg["mamba_d_head"]
    proj = x @ W["in_proj"]
    z, xbc, dt = torch.split(proj, [di, di + 2 * n, h], dim=-1)
    k = W["conv_w"].shape[0]
    conv = F.conv1d(F.pad(xbc.transpose(1, 2), (k - 1, 0)),
                    W["conv_w"].T[:, None, :], W["conv_b"], groups=xbc.shape[-1])
    xbc = F.silu(conv.transpose(1, 2))
    xs, Bm, Cm = torch.split(xbc, [di, n, n], dim=-1)
    xs = xs.reshape(b, s, h, p)
    dt = F.softplus(dt + W["dt_bias"])                      # (B, S, H)
    A = -torch.exp(W["A_log"])                               # (H,)
    if form == "recurrent":
        state = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
        ys = []
        for t in range(s):
            decay = torch.exp(dt[:, t] * A)[:, :, None, None]
            state = state * decay + (dt[:, t, :, None, None] * xs[:, t, :, :, None]
                                     * Bm[:, t, None, None, :])
            ys.append(torch.einsum("bhpn,bn->bhp", state, Cm[:, t]))
        y = torch.stack(ys, dim=1)
    elif form == "quadratic":
        cum = torch.cumsum(dt * A, dim=1)                    # (B, S, H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]        # (B, t, s, H)
        causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        L = torch.exp(seg.masked_fill(~causal[None, :, :, None], -math.inf))
        M = torch.einsum("btn,bsn->bts", Cm, Bm)[..., None] * L * dt[:, None]
        y = torch.einsum("btsh,bshp->bthp", M, xs)
    else:
        raise ValueError(f"unknown form {form!r}")
    y = (y + W["D"][None, None, :, None] * xs).reshape(b, s, di)
    y = rmsnorm(y * F.silu(z), W["norm_scale"], cfg["rms_norm_eps"])
    return y @ W["out_proj"]


def attention(W: dict, cfg: dict, x):
    """Causal NoPE GQA of x (B, S, D); W without the `blocks.i.attn.` prefix."""
    b, s, _ = x.shape
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or cfg["hidden_size"] // hq
    q = (x @ W["wq"]).reshape(b, s, hq, hd).transpose(1, 2)
    k = (x @ W["wk"]).reshape(b, s, hkv, hd).transpose(1, 2)
    v = (x @ W["wv"]).reshape(b, s, hkv, hd).transpose(1, 2)
    k = torch.repeat_interleave(k, hq // hkv, dim=1)
    v = torch.repeat_interleave(v, hq // hkv, dim=1)
    scores = (q @ k.transpose(-1, -2)) * cfg["attention_multiplier"]
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, -math.inf), dim=-1)
    return (probs @ v).transpose(1, 2).reshape(b, s, hq * hd) @ W["wo"]


def moe(W: dict, cfg: dict, x):
    """The shared expert plus the held experts' gated part, x (B, S, D); W
    without the `blocks.i.moe.` prefix."""
    logits = x @ W["router"]                                  # (B, S, E)
    top_l, top_i = torch.topk(logits, cfg["num_experts_per_tok"], dim=-1)
    gates = torch.zeros_like(logits).scatter(-1, top_i, torch.softmax(top_l, dim=-1))
    out = swiglu(x, W["shared.wg"], W["shared.wi"], W["shared.wo"])
    e0 = cfg["expert_offset"]
    for j in range(cfg["num_local_experts"]):
        out = out + gates[..., e0 + j, None] * swiglu(x, W["wg"][j], W["wi"][j], W["wo"][j])
    return out


def _layer(W: dict, i: int, prefix: str) -> dict:
    head = f"blocks.{i}.{prefix}."
    return {k[len(head):]: v for k, v in W.items() if k.startswith(head)}


def hidden(W: dict, cfg: dict, tokens, form: str = "recurrent"):
    """The final RMSNorm's output (B, S, D) of (B, S) token ids."""
    r, eps = cfg["residual_multiplier"], cfg["rms_norm_eps"]
    x = W["embed"][tokens] * cfg["embedding_multiplier"]
    for i in range(cfg["num_hidden_layers"]):
        xn = rmsnorm(x, W[f"blocks.{i}.ln1"], eps)
        if cfg["layer_types"][i] == "mamba":
            mixed = mamba2(_layer(W, i, "ssm"), cfg, xn, form)
        elif cfg["layer_types"][i] == "attention":
            mixed = attention(_layer(W, i, "attn"), cfg, xn)
        else:
            raise ValueError(f"unknown layer type {cfg['layer_types'][i]!r}")
        h = x + r * mixed
        x = h + r * moe(_layer(W, i, "moe"), cfg, rmsnorm(h, W[f"blocks.{i}.ln2"], eps))
    return rmsnorm(x, W["final_norm"], eps)


def pooled_features(W: dict, cfg: dict, tokens, form: str = "recurrent"):
    """The (B, D) features: the final hidden state's mean over the sequence."""
    with exact_fp32():
        return torch.mean(hidden(W, cfg, tokens, form), dim=1)


def features_vjp(W: dict, cfg: dict, tokens, g_X, names, block: int = 256):
    """{name: d <pooled_features(tokens), g_X> / d W[name]} for the leaves
    `names`, accumulated over blocks of `block` sequences (the quadratic
    form of the mixer, so that a block's autograd fits)."""
    leaves = {k: W[k].detach().requires_grad_(True) for k in names}
    Wg = dict(W, **leaves)
    out = {k: torch.zeros_like(v) for k, v in leaves.items()}
    with exact_fp32():
        for i in range(0, tokens.shape[0], block):
            f = torch.mean(hidden(Wg, cfg, tokens[i:i + block], "quadratic"), dim=1)
            gs = torch.autograd.grad(f, list(leaves.values()), grad_outputs=g_X[i:i + block])
            for k, g in zip(leaves, gs):
                out[k] += g
    return out


def matern32_x_grad(X, A, V, lengthscale: float, outputscale: float):
    """d/dX of (1 / 2n) sum_c A[:, c]^T K(X, X) V[:, c] for the Matern-3/2
    kernel s (1 + a) e^{-a}, a = sqrt(3) |x - z| / l: the X gradient of
    Eq. 2 (with A = [-u_y, U / t] and V = [u_y, P^-1 Z], of the per-datum
    negative log marginal likelihood), in the dtype of X."""
    n = X.shape[0]
    sq = torch.sum(X * X, dim=1)
    r = torch.sqrt(torch.clamp(sq[:, None] + sq[None, :] - 2.0 * X @ X.T, min=0.0))
    a = math.sqrt(3.0) * r / lengthscale
    Wc = A @ V.T
    # k'(r) / r = -3 s / l^2 e^{-a}, finite at r = 0
    M = (-3.0 * outputscale / lengthscale ** 2) * torch.exp(-a) * (Wc + Wc.T)
    return (torch.sum(M, dim=1)[:, None] * X - M @ X) / (2.0 * n)
