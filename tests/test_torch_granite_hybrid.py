"""The granitemoehybrid family (`repro_torch.models.hybrid_moe`, the port-only
`granite-4.0-h-small`) and the DKL trainer (`train.gp_trainer.fit_dkl`)
against the plain float32 reference (the benchmark's
`gpbench/reference/backbones/granitemoehybrid.py`, loaded by path),
on the CPU at a reduced size: d 64, two periods of four layers (Mamba-2,
NoPE attention, Mamba-2, Mamba-2), 12 experts of which 6 are held, top 4,
vocabulary 256, seeded random weights (every norm scale and bias drawn too,
so that none is left at its identity value).

* `get_arch` resolves the port-only config, whose values are the catalog's
  config.json, while `list_archs()` stays the reference's.
* Pooled features, program against reference, in fp32 (the program's SSD
  runs in chunks of 8 over sequences of 16; the reference follows the
  recurrence); the reference's two forms of the mixer agree.
* The layer pattern and each multiplier, as faults of the reference that
  must fail the same comparison.
* DKL: the loss and the gradient of every leaf (backbone and GP head) of one
  `fit_dkl` step against an exact reference (a float64 Cholesky MLL on the
  reference's features, differentiated by autograd), the head's
  preconditioner of full rank so that the SLQ estimate is exact.
* The expert shares: the held parts of every share of the experts, with the
  shared expert counted once, add up to the uncut layer.
* Routing under a skew that sends every token to the same experts drops
  nothing (`moe.dropped` reads 0) and agrees with the reference; the old
  capacity routing drops there, and a dispatch that drops pairs is counted
  by `moe.dropped`.
* The micro-batched backward equals the one-pass backward.
* Eq. 2's X gradient in the reference against autograd of the quadratic form.

Tolerances: fp32 features within 2e-5 of their norm (sums of a few hundred
products and ten residual adds); the faults move them by more than 1e-2.
DKL: loss within 1e-5 relative, each leaf's gradient within 1e-3 of its norm
(the MLL's CG runs to 1e-8 and its preconditioner is exact); the micro-batched
gradients within 1e-4 of the one-pass ones (fp32 sums in another order).
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)

import importlib.util
import math
import pathlib

import pytest
import torch

from repro_torch import obs
from repro_torch.core.dkl import DKLModel, pooled_features
from repro_torch.core.gp import ExactGP, ExactGPConfig
from repro_torch.core.kernels_math import init_params_for, params_leaves, softplus
from repro_torch.models import get_arch, list_archs
from repro_torch.models import model as lm_model
from repro_torch.models.config import ArchConfig
from repro_torch.models import hybrid_moe
from repro_torch.models.hybrid_moe import HybridMoEConfig, routed_experts
from repro_torch.models.layers import mlp_apply
from repro_torch.models.registry import ARCH_IDS, PORT_ARCH_IDS
from repro_torch.train.gp_trainer import DKLTrainConfig, _dkl_step, _phi_leaves, fit_dkl

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "gpbench" / "reference" / "backbones" / "granitemoehybrid.py"
_spec = importlib.util.spec_from_file_location("granitemoehybrid_reference", REF)
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)
FEAT_TOL = 2e-5
FAULT_GAP = 1e-2

# config.json of ibm-granite/granite-4.0-h-small (the keys that shape the model)
CATALOG = {
    "attention_multiplier": 0.0078125, "embedding_multiplier": 12,
    "hidden_size": 4096, "intermediate_size": 768, "mamba_chunk_size": 256,
    "mamba_d_conv": 4, "mamba_d_head": 64, "mamba_d_state": 128, "mamba_expand": 2,
    "mamba_n_groups": 1, "mamba_n_heads": 128, "num_attention_heads": 32,
    "num_experts_per_tok": 10, "num_hidden_layers": 40, "num_key_value_heads": 8,
    "num_local_experts": 72, "position_embedding_type": "nope",
    "residual_multiplier": 0.22, "rms_norm_eps": 1e-05,
    "shared_intermediate_size": 1536, "vocab_size": 100352,
    "layer_types": (["mamba"] * 5 + ["attention"] + ["mamba"] * 4) * 4,
}

SMALL = HybridMoEConfig(
    name="granite-small-test", n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=32, d_shared=48, vocab=256,
    layer_types=("mamba", "attention", "mamba", "mamba") * 2,
    n_experts=12, top_k=4, expert_offset=0, experts_held=6,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8, conv_kernel=4,
    residual_multiplier=0.22, embedding_multiplier=12.0,
    attention_multiplier=1.0 / 16, norm_eps=1e-5, attn_chunk=8)
SEQ, BATCH = 16, 12


def ref_cfg(cfg: HybridMoEConfig, **faults) -> dict:
    """The reference's configuration (config.json's keys) of a program config."""
    out = {
        "hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.hd,
        "mamba_expand": cfg.ssm_expand, "mamba_d_state": cfg.ssm_state,
        "mamba_n_heads": cfg.ssm_heads, "mamba_d_head": cfg.ssm_head_dim,
        "num_experts_per_tok": cfg.top_k, "num_local_experts": len(cfg.held),
        "router_experts": cfg.n_experts, "expert_offset": cfg.expert_offset,
        "residual_multiplier": cfg.residual_multiplier,
        "embedding_multiplier": cfg.embedding_multiplier,
        "attention_multiplier": cfg.attention_multiplier,
        "rms_norm_eps": cfg.norm_eps, "num_hidden_layers": cfg.n_layers,
        "layer_types": list(cfg.layer_types),
    }
    out.update(faults)
    return out


def make_lm(cfg=SMALL, seed=0):
    g = torch.Generator().manual_seed(seed)
    lm = lm_model.init_params(cfg, g, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for name, p in lm.named_parameters():
            if p.ndim == 1:   # norm scales, conv bias, dt bias, D, A_log
                p.add_(0.3 * torch.randn(p.shape, generator=g))
    return lm


def weights(lm) -> dict:
    return {k: v.detach().clone() for k, v in lm.named_parameters()}


def tokens(n=BATCH, seed=1, vocab=256):
    return torch.randint(0, vocab, (n, SEQ), generator=torch.Generator().manual_seed(seed))


def rel(a, b) -> float:
    return float(torch.linalg.norm((a - b).double()) / torch.linalg.norm(b.double()))


# -- registry ---------------------------------------------------------------


def test_get_arch_resolves_the_port_only_config():
    cfg = get_arch("granite-4.0-h-small")
    assert isinstance(cfg, HybridMoEConfig) and not isinstance(cfg, ArchConfig)
    assert "granite-4.0-h-small" in PORT_ARCH_IDS
    assert "granite-4.0-h-small" not in list_archs() and list_archs() == ARCH_IDS
    assert lm_model.count_params(cfg._replace(n_layers=10, experts_held=9)) == 2_414_692_992


def test_config_values_are_the_catalogs():
    cfg = get_arch("granite-4.0-h-small")
    mine = {
        "attention_multiplier": cfg.attention_multiplier,
        "embedding_multiplier": cfg.embedding_multiplier, "hidden_size": cfg.d_model,
        "intermediate_size": cfg.d_ff, "mamba_chunk_size": cfg.ssm_chunk,
        "mamba_d_conv": cfg.conv_kernel, "mamba_d_head": cfg.ssm_head_dim,
        "mamba_d_state": cfg.ssm_state, "mamba_expand": cfg.ssm_expand,
        "mamba_n_groups": 1, "mamba_n_heads": cfg.ssm_heads,
        "num_attention_heads": cfg.n_heads, "num_experts_per_tok": cfg.top_k,
        "num_hidden_layers": cfg.n_layers, "num_key_value_heads": cfg.n_kv_heads,
        "num_local_experts": len(cfg.held), "position_embedding_type": "nope",
        "residual_multiplier": cfg.residual_multiplier, "rms_norm_eps": cfg.norm_eps,
        "shared_intermediate_size": cfg.d_shared, "vocab_size": cfg.vocab,
        "layer_types": list(cfg.layer_types),
    }
    assert mine == CATALOG
    assert cfg.hd == 128 and cfg.n_experts == 72


def test_serving_paths_raise():
    lm = make_lm()
    batch = {"tokens": tokens(2), "targets": tokens(2)}
    with pytest.raises(NotImplementedError):
        lm_model.init_decode_state(SMALL, 2, SEQ, device="cpu")
    with pytest.raises(NotImplementedError):
        lm_model.prefill(SMALL, lm, {}, batch)
    with pytest.raises(NotImplementedError):
        lm_model.decode_step(SMALL, lm, {"t": 0}, tokens(2)[:, 0])
    with pytest.raises(NotImplementedError):
        lm_model.train_loss(SMALL, lm, batch)


# -- the forward against the reference --------------------------------------


@pytest.mark.parametrize("form", ["recurrent", "quadratic"])
def test_pooled_features_match_the_reference(form):
    lm = make_lm()
    tok = tokens()
    with torch.no_grad():
        prog = pooled_features(SMALL, lm, tok, device="cpu")
        want = ref.pooled_features(weights(lm), ref_cfg(SMALL), tok, form)
    assert prog.shape == (BATCH, SMALL.d_model) and prog.dtype == torch.float32
    assert rel(prog, want) < FEAT_TOL


SWAPPED = list(SMALL.layer_types)
SWAPPED[1], SWAPPED[2] = SWAPPED[2], SWAPPED[1]


@pytest.mark.parametrize("fault", [
    {},
    {"layer_types": SWAPPED},
    {"residual_multiplier": 1.0},
    {"embedding_multiplier": 1.0},
    {"attention_multiplier": 1.0 / math.sqrt(16)},
    {"rms_norm_eps": 1e-1},
], ids=["sound", "layer_pattern", "residual_multiplier", "embedding_multiplier",
        "attention_multiplier", "norm_eps"])
def test_pattern_and_multipliers_faults_fail(fault):
    """The sound reference passes the features comparison; each fault of the
    pattern (layers 1 and 2 swapped, their mixers' weights taken from an LM
    of that pattern) or of a multiplier fails it."""
    lm = make_lm()
    tok = tokens()
    W = weights(lm)
    if "layer_types" in fault:
        alt = weights(make_lm(SMALL._replace(layer_types=tuple(SWAPPED)), seed=2))
        W.update({k: v for k, v in alt.items()
                  if k.startswith(("blocks.1.ssm.", "blocks.2.attn."))})
    with torch.no_grad():
        prog = pooled_features(SMALL, lm, tok, device="cpu")
        gap = rel(prog, ref.pooled_features(W, ref_cfg(SMALL, **fault), tok))
    assert (gap < FEAT_TOL) if not fault else (gap > FAULT_GAP)


# -- routing ----------------------------------------------------------------


def _moe_ref(W, cfg, x, layer=0):
    head = f"blocks.{layer}.moe."
    return ref.moe({k[len(head):]: v for k, v in W.items() if k.startswith(head)},
                   ref_cfg(cfg), x)


@pytest.mark.parametrize("shares", [(6, 6), (4, 4, 4), (12,)])
def test_expert_shares_add_up_to_the_uncut_layer(shares):
    full = SMALL._replace(experts_held=12)
    lm = make_lm(full)
    moe = lm.blocks[0].moe
    x = torch.randn((3, SEQ, 64), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        uncut = moe(full, x)
        shared = mlp_apply("swiglu", moe.shared, x)
        total, e0 = shared.clone(), 0
        for h in shares:
            cfg = full._replace(expert_offset=e0, experts_held=h)
            part = lm_model.init_params(cfg, dtype=torch.float32, device="meta").blocks[0].moe
            part = part.to_empty(device="cpu")
            part.load_state_dict({"router": moe.router, "wi": moe.wi[e0:e0 + h],
                                  "wg": moe.wg[e0:e0 + h], "wo": moe.wo[e0:e0 + h],
                                  **{f"shared.{k}": v for k, v in moe.shared.items()}})
            total += part(cfg, x) - shared
            e0 += h
        want = _moe_ref(weights(lm), full, x)
    assert rel(total, uncut) < 1e-6
    assert rel(uncut, want) < FEAT_TOL


def test_skewed_routing_drops_nothing():
    """Every token's top 4 are experts 0, 11, 10 and 9: the held experts 0
    and 9-11 take every token. Nothing drops, and the output is the
    reference's; the capacity routing of `models/moe.py` (factor 1.25)
    drops pairs there."""
    from repro_torch.models.moe import moe_route

    full = SMALL._replace(experts_held=12)
    lm = make_lm(full)
    moe = lm.blocks[0].moe
    x = torch.rand((4, SEQ, 64), generator=torch.Generator().manual_seed(6)) + 0.1
    with torch.no_grad():
        moe.router.zero_()
        moe.router[:, 0] = 1.0
        for j in range(1, 12):
            moe.router[:, j] = 0.01 * j
        dropped = obs.counter("moe.dropped").value
        pairs = obs.counter("moe.routed_pairs_held").value
        got = routed_experts(moe, full, x)
        assert obs.counter("moe.dropped").value == dropped
        assert obs.counter("moe.routed_pairs_held").value - pairs == 4 * SEQ * 4
        assert obs.gauge("moe.max_expert_pairs").value >= 4 * SEQ
        want = _moe_ref(weights(lm), full, x) - mlp_apply("swiglu", moe.shared, x)
        keep = moe_route({"router": moe.router}, x, top_k=4, capacity_factor=1.25)[5]
    assert rel(got, want) < FEAT_TOL
    assert not bool(keep.all())


def test_a_dispatch_that_drops_pairs_is_counted(monkeypatch):
    """`moe.dropped` counts the router's held choices against the pairs the
    experts computed: a dispatch that loses each held expert's last pair
    (a stand-in for a capacity) reads one drop per expert with pairs."""
    dispatch = hybrid_moe.dispatch

    def lossy(top_i, gates, held):
        tok, gate, sizes = dispatch(top_i, gates, held)
        ends = torch.cumsum(sizes, 0)[sizes > 0] - 1
        keep = torch.ones(int(sizes.sum()), dtype=torch.bool)
        keep[ends] = False
        return tok[:keep.numel()][keep], gate[:keep.numel()][keep], (sizes - 1).clamp(min=0)

    lm = make_lm()
    x = torch.randn((3, SEQ, 64), generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        tok, _, sizes = dispatch(*hybrid_moe.route(lm.blocks[0].moe.router, SMALL,
                                                   x.reshape(-1, 64)), SMALL.held)
        monkeypatch.setattr(hybrid_moe, "dispatch", lossy)
        dropped = obs.counter("moe.dropped").value
        pairs = obs.counter("moe.routed_pairs_held").value
        routed_experts(lm.blocks[0].moe, SMALL, x)
    assert obs.counter("moe.routed_pairs_held").value - pairs == int(sizes.sum())
    assert obs.counter("moe.dropped").value - dropped == int((sizes > 0).sum()) > 0


# -- DKL ----------------------------------------------------------------------


N_DKL = 24
GP_CFG = ExactGPConfig(kernel="matern32", precond_rank=N_DKL, num_probes=8,
                       train_cg_tol=1e-8, train_max_cg_iters=200, row_block=8,
                       backend="partitioned")


def _dkl_problem():
    lm = make_lm()
    tok = tokens(N_DKL, seed=3)
    y = torch.sin(tok[:, ::4].double().mean(1) / 40.0).float()
    y = (y - y.mean()) / y.std()
    with torch.no_grad():
        f = pooled_features(SMALL, lm, tok, device="cpu")
    ls = float(torch.cdist(f, f).median())
    gp_params = init_params_for("matern32", lengthscale=ls, noise=0.1, device="cpu")
    model = DKLModel(ExactGP(GP_CFG, device="cpu"),
                     lambda phi, t: pooled_features(SMALL, phi, t, device="cpu"))
    return lm, tok, y, gp_params, model


def _reference_loss(feats, y, raw, Z):
    """(value, surrogate) of the per-datum negative log marginal likelihood
    of the Matern-3/2 GP on `feats` by a float64 Cholesky; raw = (lengthscale,
    outputscale, noise, mean) raw leaves. `value` is exact; the surrogate's
    gradient is Eq. 2's with the probes Z: the data-fit term exact, the
    trace term mean_i u_i^T dK P^-1 z_i with u_i = P^-1 z_i = K^-1 z_i (the
    head's preconditioner is of full rank)."""
    ls, s = softplus(raw[0]), softplus(raw[1])
    noise = softplus(raw[2]) + 1e-4
    X = feats.double()
    r = torch.sqrt(torch.clamp(torch.cdist(X, X) ** 2, min=1e-30))
    a = math.sqrt(3.0) * r / ls
    n = X.shape[0]
    K = s * (1 + a) * torch.exp(-a) + noise * torch.eye(n, dtype=X.dtype)
    L = torch.linalg.cholesky(K)
    yc = y.double() - raw[3]
    quad = yc @ torch.cholesky_solve(yc[:, None], L)[:, 0]
    logdet = 2 * torch.log(torch.diagonal(L)).sum()
    value = 0.5 * (quad + logdet + n * math.log(2 * math.pi)) / n
    U = torch.cholesky_solve(Z.double(), L).detach()
    trace = torch.sum(U * (K @ U)) / Z.shape[1]
    return value, 0.5 * (quad + trace) / n


def test_dkl_loss_and_every_gradient_match_the_reference(monkeypatch):
    import repro_torch.core.mll as mll_mod

    lm, tok, y, gp_params, model = _dkl_problem()
    phi, leaves = _phi_leaves(lm)
    names = [k for k, _ in lm.named_parameters()]
    seen = {}
    forward = mll_mod.operator_mll_forward

    def recording(*a, **kw):
        out = forward(*a, **kw)
        seen["probes"] = out[2].probes
        return out

    monkeypatch.setattr(mll_mod, "operator_mll_forward", recording)
    gen = torch.Generator().manual_seed(0)
    loss, _, _, _, g_phi, g_gp = _dkl_step(model, tok, y, phi, leaves, gp_params, gen, 0)

    W = {k: v.detach().clone().requires_grad_(True) for k, v in weights(lm).items()}
    raw = [a.detach().double().requires_grad_(True) for a in params_leaves(gp_params)]
    value, surrogate = _reference_loss(ref.pooled_features(W, ref_cfg(SMALL), tok), y,
                                       raw, seen["probes"])
    g_ref = torch.autograd.grad(surrogate, list(W.values()) + raw)
    value = float(value.detach())
    assert abs(float(loss) - value) < 1e-5 * abs(value)
    gaps = {name: rel(g, gr) for name, g, gr in zip(names, g_phi, g_ref)}
    gaps.update({f"gp.{i}": abs(float(g) - float(gr)) / max(abs(float(gr)), 1e-3)
                 for i, (g, gr) in enumerate(zip(params_leaves(g_gp), g_ref[len(names):]))})
    bad = {k: v for k, v in gaps.items() if not v < 1e-3}
    assert bad == {}


def test_microbatched_backward_equals_one_pass():
    lm, tok, y, gp_params, model = _dkl_problem()
    phi, leaves = _phi_leaves(lm)
    one = _dkl_step(model, tok, y, phi, leaves, gp_params,
                    torch.Generator().manual_seed(0), 0)
    mb = _dkl_step(model, tok, y, phi, leaves, gp_params,
                   torch.Generator().manual_seed(0), 8)
    assert torch.equal(one[3], mb[3])            # the same g_X
    for a, b in zip(one[4], mb[4]):
        # fp32 sums in another order: a few ulps of the largest terms, which
        # in a leaf whose contributions cancel (A_log) reads up to ~2e-5 of
        # its norm
        assert rel(b, a) < 1e-4


def test_fit_dkl_moves_both_and_counts_microbatches():
    lm, tok, y, gp_params, model = _dkl_problem()
    before = weights(lm)
    count = obs.counter("dkl.microbatches").value
    res = fit_dkl(model, tok, y, lm, gp_params,
                  cfg=DKLTrainConfig(adam_steps=2, lr=1e-2, microbatch=10), device="cpu")
    assert res.route == "microbatch" and res.microbatches == 3
    assert obs.counter("dkl.microbatches").value - count == 6
    assert res.phi_params is lm and len(res.loss_trace) == 2
    assert int(res.state.step) == 2
    moved = {k: float((v - before[k]).abs().max()) for k, v in weights(lm).items()}
    assert moved["embed"] > 0 and moved["blocks.1.attn.wq"] > 0
    assert all(float((a - b).abs()) > 0 for a, b in
               zip(params_leaves(res.gp_params), params_leaves(gp_params)))


# -- the reference's own pieces ----------------------------------------------


def test_matern32_x_grad_is_the_quadratic_forms_gradient():
    g = torch.Generator().manual_seed(7)
    X = torch.randn((20, 5), generator=g, dtype=torch.float64)
    A = torch.randn((20, 3), generator=g, dtype=torch.float64)
    V = torch.randn((20, 3), generator=g, dtype=torch.float64)
    ls, s = 1.3, 0.7
    Xg = X.clone().requires_grad_(True)
    r = torch.sqrt(torch.clamp(torch.cdist(Xg, Xg) ** 2, min=1e-30))
    a = math.sqrt(3.0) * r / ls
    quad = torch.sum(A * ((s * (1 + a) * torch.exp(-a)) @ V)) / (2 * 20)
    (want,) = torch.autograd.grad(quad, Xg)
    assert rel(ref.matern32_x_grad(X, A, V, ls, s), want) < 1e-10


def test_features_vjp_is_autograd_of_the_features():
    lm = make_lm()
    tok = tokens(6)
    W = weights(lm)
    gx = torch.randn((6, 64), generator=torch.Generator().manual_seed(8))
    names = ["embed", "blocks.0.ssm.in_proj", "blocks.1.attn.wq", "blocks.7.moe.router"]
    got = ref.features_vjp(W, ref_cfg(SMALL), tok, gx, names, block=4)
    Wg = {k: v.clone().requires_grad_(True) for k, v in W.items()}
    f = ref.pooled_features(Wg, ref_cfg(SMALL), tok)
    want = torch.autograd.grad(f, [Wg[k] for k in names], grad_outputs=gx)
    for k, w in zip(names, want):
        assert rel(got[k], w) < 1e-5


def test_reference_imports_nothing_of_the_program():
    text = REF.read_text()
    assert "repro_torch" not in text and "jax" not in text
