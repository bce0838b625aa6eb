"""Mixture-of-experts FFN: top-k routing with capacity-factor dispatch.

The counterpart of `repro.models.moe`. Tokens are gathered into a
(B, E, capacity, D) buffer, run through batched expert SwiGLUs, and
gathered back weighted by the renormalised router probabilities: no dense
all-expert compute. Routing is per sequence, as in the reference: the
capacity is `max(int(capacity_factor * k * S / E), 1)` slots per expert
and sequence, a (token, k) pair's slot comes from a cumulative count over
the (S, k) flattening in that order, and pairs past an expert's capacity
go to one overflow slot (`E * capacity`) that is never read, so they drop.
Every dropped pair writes that slot; which write wins is unspecified on
CUDA and does not matter.

The router is fp32 whatever the model's dtype. The load-balance aux loss is
Switch-style, per sequence then averaged: its count term comes from the
integer one-hot and carries no gradient, its `me` term from the router's
probabilities, which do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import mlp_apply, mlp_params, normal_init
from .shardctx import axis_size, current_mesh, local, shard

# MoE.forward under a mesh: each weight's layout on the rank's batch shard
# (the expert hidden dim over model)
_TP_SPECS = {"router": (None, None), "wi": (None, None, "tp"),
             "wg": (None, None, "tp"), "wo": (None, "tp", None),
             "shared.wi": (None, "tp"), "shared.wg": (None, "tp"),
             "shared.wo": ("tp", None)}


class MoE(nn.Module):
    """The expert weights, named as the reference's dict: `router` (D, E)
    fp32, `wi` / `wg` (E, D, F), `wo` (E, F, D), and `shared` (a SwiGLU of
    hidden F * n_shared) where the config has shared experts. `p[key]` and
    `key in p` read as the dict's do. A module (not a `ParameterDict`) so
    that forward hooks can watch its inputs."""

    def __init__(self, generator, d: int, f_expert: int, n_experts: int,
                 n_shared: int, dtype, device):
        super().__init__()
        s = (2.0 / d) ** 0.5
        so = (2.0 / f_expert) ** 0.5
        self.router = nn.Parameter(normal_init((d, n_experts), 0.02, generator,
                                               torch.float32, device))
        self.wi = nn.Parameter(normal_init((n_experts, d, f_expert), s,
                                           generator, dtype, device))
        self.wg = nn.Parameter(normal_init((n_experts, d, f_expert), s,
                                           generator, dtype, device))
        self.wo = nn.Parameter(normal_init((n_experts, f_expert, d), so,
                                           generator, dtype, device))
        if n_shared:
            self.shared = mlp_params("swiglu", generator, d, f_expert * n_shared,
                                     dtype, device)

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return hasattr(self, key)

    def forward(self, x, *, top_k: int, capacity_factor: float):
        """moe_apply on x (B, S, D); under a mesh, on each rank's batch
        shard (routing is per sequence, so it stays local) with the expert
        hidden dim over model: the output is a partial sum over model. The
        aux loss is a partial sum over every axis: each rank's batch-shard
        mean divided by the rank count (the batch shards are equal), so
        that its gradient splits over the ranks as the output's does."""
        if current_mesh() is None:
            return moe_apply(self, x, top_k=top_k, capacity_factor=capacity_factor)
        names, ws = zip(*self.named_parameters())
        tok = ("fsdp", None, None)
        ranks = axis_size("pod") * axis_size("data") * axis_size("model")

        def run(x_, *ws_):
            p = dict(zip(names, ws_))
            if "shared.wi" in p:
                p["shared"] = {k: p.pop(f"shared.{k}") for k in ("wi", "wg", "wo")}
            out, aux = moe_apply(p, x_, top_k=top_k,
                                 capacity_factor=capacity_factor)
            return out, aux / ranks

        return local(run, (x, *ws), (tok, *(_TP_SPECS[n] for n in names)),
                     [tok, ()], [{"model": "sum"},
                                 {"pod": "sum", "data": "sum", "model": "sum"}])


def moe_route(p, x, *, top_k: int, capacity_factor: float):
    """The dispatch plan of x (B, S, D): the router's probabilities
    (B, S, E), the renormalised top-k weights and experts (B, S, k), the
    integer one-hot (B, S, k, E), each (token, k) pair's slot (B, S * k)
    and whether it kept one (B, S * k), and the capacity."""
    b, s, _ = x.shape
    e = p["router"].shape[1]
    logits = x.to(torch.float32) @ p["router"]               # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, top_k, dim=-1)          # (B, S, k)
    top_p = top_p / torch.sum(top_p, -1, keepdim=True)       # renormalize
    capacity = max(int(capacity_factor * top_k * s / e), 1)
    # per-sequence position of each (token, k) within its expert
    onehot = F.one_hot(top_i, e)                             # (B, S, k, E)
    flat_oh = onehot.reshape(b, s * top_k, e)
    pos = torch.sum(torch.cumsum(flat_oh, dim=1) * flat_oh, -1) - 1
    keep = (pos >= 0) & (pos < capacity)
    slot = torch.where(keep, top_i.reshape(b, s * top_k) * capacity + pos,
                       e * capacity)                         # overflow slot
    return probs, top_p, top_i, onehot, slot, keep, capacity


def moe_apply(p, x, *, top_k: int, capacity_factor: float = 1.25):
    """x (B, S, D) -> (B, S, D) with the auxiliary load-balance loss."""
    b, s, d = x.shape
    e = p["router"].shape[1]
    probs, top_p, _, onehot, slot, keep, capacity = moe_route(
        p, x, top_k=top_k, capacity_factor=capacity_factor)

    # scatter: tokens -> (B, E * capacity [+1 overflow], D)
    vals = torch.repeat_interleave(x, top_k, dim=1)          # (B, S * k, D)
    bidx = torch.arange(b, device=x.device)[:, None].expand(b, s * top_k)
    buf = torch.zeros((b, e * capacity + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((bidx, slot), vals)
    expert_in = shard(buf[:, :-1].reshape(b, e, capacity, d),
                      "fsdp", None, None, None)

    # batched expert SwiGLU: (B, E, C, D) x (E, D, F), F over model
    h = F.silu(torch.einsum("becd,edf->becf", expert_in, p["wg"])) * \
        torch.einsum("becd,edf->becf", expert_in, p["wi"])
    h = shard(h, "fsdp", None, None, "tp")
    expert_out = torch.einsum("becf,efd->becd", h, p["wo"])  # (B, E, C, D)

    # combine: gather back per sequence, weight by router prob
    flat_out = expert_out.reshape(b, e * capacity, d)
    safe_slot = torch.where(keep, slot, 0)
    gathered = torch.gather(flat_out, 1, safe_slot[..., None].expand(-1, -1, d))
    gathered = torch.where(keep[..., None], gathered, 0.0)   # (B, S * k, D)
    weighted = gathered.reshape(b, s, top_k, d) * top_p[..., None].to(x.dtype)
    out = torch.sum(weighted, dim=2)

    if "shared" in p:
        out = out + mlp_apply("swiglu", p["shared"], x)

    # load-balance auxiliary loss (Switch-style), per sequence then averaged
    me = torch.mean(probs, dim=1)                            # (B, E)
    ce = torch.mean(torch.sum(onehot, dim=2).to(torch.float32), dim=1)
    aux = e * torch.mean(torch.sum(me * ce, dim=-1))
    return out, aux
