"""The port's LM serving path and the modules it adds, on the CPU in fp32.

* `decode_attention` against the reference's, with and without a window,
  at a position inside the cache and at its end (GQA, 6 query heads on 2
  KV heads).
* `apply_mrope` with distinct (t, h, w) streams, and the text case, where
  it equals plain RoPE.
* `moe_apply` on qwen2-moe's reduced config at capacity factor 1.25, where
  tokens drop: the same (token, k) pairs drop as under the reference's
  rule, and the output and aux match the reference's.
* `ssd_apply` at a length that is not a multiple of the chunk; the chunked
  SSD against sequential decode (the reference's
  `test_mamba2_train_decode_state_equivalence`, on the port), and the
  prefill state against the state after the same tokens decoded one by
  one.
* The reference's decode-consistency check (`tests/test_models_smoke.py`)
  on the port for all 10 reduced LM configs: prefill S - 1 tokens, decode
  the last, within 2e-3 of max|logit| of the full forward.
* Decode writes the caches in place: every cache tensor keeps its storage
  (`data_ptr`) across `decode_step`, slot t changes, and `t` stays an int.
* The decode state converters both ways, the window schedule against the
  reference's, the deep-kernel-learning features bit for bit through the
  dense-only forward the port had before the other families, and the
  serve launcher's and the example's `main` on `--device cpu`; without a
  card they raise.

Tolerances: the conformance ones (`tests/test_conformance.py:61`), arrays
within 2e-4 of their largest entry, scalars within 3e-5 relative.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_arch as ref_get_arch
from repro.models import layers as ref_layers
from repro.models import registry as ref_registry
from repro.models.attention import decode_attention as ref_decode_attention
from repro.models.model import _win_schedule as ref_win_schedule
from repro.models.model import init_decode_state as ref_init_decode_state
from repro.models.moe import moe_apply as ref_moe_apply
from repro.models.moe import moe_params as ref_moe_params
from repro.models.ssd import ssd_apply as ref_ssd_apply
from repro.models.ssd import ssd_params as ref_ssd_params
from repro_torch.core.dkl import pooled_features
from repro_torch.interop import decode_state_from_numpy, decode_state_to_numpy
from repro_torch.models import (
    LM, decode_step, forward_hidden, get_arch, init_decode_state, prefill)
from repro_torch.models import layers
from repro_torch.models.attention import attention, decode_attention, qkv_proj
from repro_torch.models.model import _ssd_prefill_state, _win_schedule
from repro_torch.models.moe import MoE, moe_apply, moe_route
from repro_torch.models.ssd import (
    ssd_apply, ssd_decode_step, ssd_init_state, ssd_params)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAT_TOL = 2e-4
VAL_TOL = 3e-5
LM_ARCHS = tuple(a for a in ref_registry.ARCH_IDS if a != "gp-exact-1m")


def _close(a, b, tol=MAT_TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _from_ref(tree):
    """A reference param dict (jax leaves) as numpy, for the port's dicts."""
    return jax.tree.map(np.asarray, tree)


def _load(module, tree):
    """Copy a numpy param dict into a port module named as the dict."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            node = tree
            for key in name.split("."):
                node = node[key]
            p.copy_(torch.as_tensor(np.array(node)))
    return module


# ---------------------------------------------------------------------------
# attention and rotary embeddings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", (5, 11), ids=("inside", "end"))
@pytest.mark.parametrize("window", (0, 4))
def test_decode_attention_matches_reference(t, window):
    rng = np.random.default_rng(0)
    q = _rand(rng, 2, 1, 6, 8)
    k, v = _rand(rng, 2, 12, 2, 8), _rand(rng, 2, 12, 2, 8)
    ref = ref_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               t, window=window)
    out = decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                           torch.as_tensor(v), t, window=window)
    _close(out, ref)
    # the slots the mask drops do not reach the output
    k2, v2 = k.copy(), v.copy()
    k2[:, t + 1:] = v2[:, t + 1:] = 1e3
    if window:
        k2[:, :t - window + 1] = v2[:, :t - window + 1] = 1e3
    out2 = decode_attention(torch.as_tensor(q), torch.as_tensor(k2),
                            torch.as_tensor(v2), t, window=window)
    assert torch.equal(out, out2)


def test_mrope_matches_reference_with_distinct_streams():
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 9, 3, 16)
    pos3 = rng.integers(0, 50, size=(3, 2, 9)).astype(np.int32)
    assert len({tuple(p.ravel()) for p in pos3}) == 3
    sections = (4, 2, 2)
    ref = ref_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, sections)
    out = layers.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos3), 1e6, sections)
    _close(out, ref)
    # text tokens (t = h = w) reduce to plain RoPE
    text = np.broadcast_to(pos3[:1], pos3.shape).copy()
    np.testing.assert_allclose(
        layers.apply_mrope(torch.as_tensor(x), torch.as_tensor(text), 1e6,
                           sections).numpy(),
        layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos3[0]), 1e6).numpy(),
        rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos3), 1e6, (4, 2, 1))


def test_positions_for_mrope_streams():
    cfg = get_arch("qwen2-vl-7b").reduced()
    pos = layers.positions_for(cfg, 2, 5, offset=3)
    assert pos.shape == (3, 2, 5) and pos.dtype == torch.int32
    ref = ref_layers.positions_for(ref_get_arch("qwen2-vl-7b").reduced(), 2, 5, offset=3)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _ref_keep(params, x, top_k, capacity_factor):
    """The reference's drop rule (`repro/models/moe.py:54-64`), on its own
    router: which (token, k) pairs keep a slot, (B, S * k)."""
    b, s, _ = x.shape
    e = params["router"].shape[1]
    probs = jax.nn.softmax(x @ params["router"], axis=-1)
    _, top_i = jax.lax.top_k(probs, top_k)
    capacity = max(int(capacity_factor * top_k * s / e), 1)
    flat = jax.nn.one_hot(top_i, e, dtype=jnp.int32).reshape(b, s * top_k, e)
    pos = jnp.sum(jnp.cumsum(flat, axis=1) * flat, -1) - 1
    return np.asarray((pos >= 0) & (pos < capacity))


def test_moe_drops_the_reference_pairs_and_matches():
    cfg = get_arch("qwen2-moe-a2.7b").reduced(capacity_factor=1.25)
    params = ref_moe_params(jax.random.PRNGKey(3), cfg.d_model, cfg.d_ff,
                            cfg.n_experts, cfg.n_shared_experts, cfg.top_k,
                            jnp.float32)
    moe = _load(MoE(None, cfg.d_model, cfg.d_ff, cfg.n_experts,
                    cfg.n_shared_experts, torch.float32, "meta").to_empty(device="cpu"),
                _from_ref(params))
    assert moe["router"].dtype == torch.float32 and "shared" in moe
    # correlated tokens (a shared component) crowd the same experts
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 64, cfg.d_model) + 2.0 * _rand(rng, 1, 1, cfg.d_model)
    kw = dict(top_k=cfg.top_k, capacity_factor=1.25)
    keep = moe_route(moe, torch.as_tensor(x), **kw)[5].numpy()
    ref_keep = _ref_keep(params, jnp.asarray(x), **kw)
    assert (~keep).sum() > 0, "nothing dropped: the case does not test drops"
    np.testing.assert_array_equal(keep, ref_keep)
    ref_out, ref_aux = ref_moe_apply(params, jnp.asarray(x), **kw)
    with torch.no_grad():
        out, aux = moe_apply(moe, torch.as_tensor(x), **kw)
        out_all, _ = moe_apply(moe, torch.as_tensor(x), top_k=cfg.top_k,
                               capacity_factor=float(cfg.n_experts))
    _close(out, ref_out)
    assert abs(float(aux) - float(ref_aux)) <= VAL_TOL * abs(float(ref_aux))
    # where nothing can drop (capacity k * S), the tokens whose pairs all
    # kept a slot are unchanged and the others move
    hit = torch.as_tensor((~keep.reshape(2, 64, cfg.top_k)).any(-1))
    _close(out[~hit], out_all[~hit].numpy())
    assert not torch.allclose(out[hit], out_all[hit], rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------


def _ssd(cfg, key=0):
    params = ref_ssd_params(jax.random.PRNGKey(key), cfg, jnp.float32)
    p = ssd_params(None, cfg, torch.float32, "meta")
    p = _load(p.to_empty(device="cpu"), _from_ref(params))
    for name in ("A_log", "dt_bias", "D"):
        assert p[name].dtype == torch.float32
    return params, p


def test_ssd_apply_matches_reference_at_a_ragged_length():
    cfg = get_arch("mamba2-130m").reduced()
    assert 40 % cfg.ssm_chunk
    params, p = _ssd(cfg)
    x = _rand(np.random.default_rng(5), 2, 40, cfg.d_model, scale=0.5)
    ref = ref_ssd_apply(params, cfg, jnp.asarray(x))
    _close(ssd_apply(p, cfg, torch.as_tensor(x)), ref)


def test_chunked_ssd_equals_sequential_decode():
    """The reference's test_mamba2_train_decode_state_equivalence on the
    port, then the prefill state against the decoded one."""
    cfg = get_arch("mamba2-130m").reduced()
    p = ssd_params(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    x = 0.5 * torch.randn((1, 32, cfg.d_model), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y_par = ssd_apply(p, cfg, x)
        state = ssd_init_state(cfg, 1, torch.float32, "cpu")
        ys = []
        for t in range(32):
            y_t, state = ssd_decode_step(p, cfg, state, x[:, t:t + 1])
            ys.append(y_t)
        np.testing.assert_allclose(y_par.numpy(), torch.cat(ys, 1).numpy(),
                                   rtol=2e-3, atol=2e-3)
        pre = ssd_init_state(cfg, 1, torch.float32, "cpu")
        _ssd_prefill_state(cfg, p, x, pre)
    _close(pre["conv"], state["conv"].numpy())
    _close(pre["ssm"], state["ssm"].numpy())


# ---------------------------------------------------------------------------
# the model's serving path
# ---------------------------------------------------------------------------


def _smoke_batch(cfg, B=2, S=64, seed=0):
    """The reference smoke test's batch (`tests/test_models_smoke.py`)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)))}
    if cfg.is_encdec:
        batch["enc_embeds"] = torch.as_tensor(_rand(rng, B, S, cfg.d_model, scale=0.1))
    if cfg.family == "vlm":
        batch["embeds"] = torch.as_tensor(_rand(rng, B, S, cfg.d_model, scale=0.1))
        mask = torch.zeros((B, S), dtype=torch.bool)
        mask[:, :8] = True
        batch["embed_mask"] = mask
    return batch


def _lm(cfg, seed=0):
    return LM(cfg, torch.Generator().manual_seed(seed), torch.float32, "cpu")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_consistency(arch):
    """The reference's own check on the port: prefill + one decode step ==
    the full forward's last logits, within 2e-3 of max|logit|."""
    cfg = get_arch(arch).reduced()
    lm, batch, S = _lm(cfg), _smoke_batch(cfg), 64
    state = init_decode_state(cfg, 2, S, torch.float32,
                              enc_len=S if cfg.is_encdec else 0, device="cpu")
    pre = {k: (v[:, :S - 1] if k in ("tokens", "embed_mask", "embeds") else v)
           for k, v in batch.items()}
    state, _ = prefill(cfg, lm, state, pre)
    assert state["t"] == S - 1
    state, logits = decode_step(cfg, lm, state, batch["tokens"][:, S - 1])
    assert state["t"] == S and logits.shape == (2, cfg.vocab)
    with torch.no_grad():
        h, _ = forward_hidden(cfg, lm, batch)
        full = h[:, -1] @ lm.embed.T
    rel = float(torch.max(torch.abs(logits - full)) / torch.max(torch.abs(full)))
    assert rel < 2e-3, rel


@pytest.mark.parametrize("arch", ("qwen2-moe-a2.7b", "mamba2-130m", "hymba-1.5b",
                                  "seamless-m4t-large-v2"))
def test_decode_writes_caches_in_place(arch):
    cfg = get_arch(arch).reduced()
    lm, batch = _lm(cfg), _smoke_batch(cfg, S=24)
    state = init_decode_state(cfg, 2, 32, torch.float32,
                              enc_len=24 if cfg.is_encdec else 0, device="cpu")
    state, _ = prefill(cfg, lm, state, batch)

    def leaves(layer, prefix=""):
        for key, v in layer.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + key + ".")
            else:
                yield prefix + key, v

    named = [(i, n, v) for i, c in enumerate(state["caches"]) for n, v in leaves(c)]
    before = {(i, n): (v, v.data_ptr(), v.clone()) for i, n, v in named}
    tok = batch["tokens"][:, -1]
    for _ in range(3):
        t = state["t"]
        state, _ = decode_step(cfg, lm, state, tok)
        assert type(state["t"]) is int and state["t"] == t + 1
    after = [(i, n, v) for i, c in enumerate(state["caches"]) for n, v in leaves(c)]
    assert [(i, n) for i, n, _ in after] == [(i, n) for i, n, _ in named]
    for i, n, v in after:
        tensor, ptr, old = before[(i, n)]
        assert v is tensor and v.data_ptr() == ptr, (i, n)
        if n in ("k", "v"):      # slots 24-26 written, the rest untouched
            assert torch.all(old[:, 24:27] == 0) and torch.all(v[:, 24:27] != 0)
            assert torch.equal(v[:, :24], old[:, :24]) and not torch.any(v[:, 27:])
        elif n in ("ck", "cv"):  # the encoder's K/V stay as prefill wrote them
            assert torch.equal(v, old)
        else:                    # the SSD's conv and recurrent states move
            assert not torch.equal(v, old), (i, n)


@pytest.mark.parametrize("arch", ("hymba-1.5b", "seamless-m4t-large-v2"))
def test_decode_state_converters_round_trip(arch):
    cfg = get_arch(arch).reduced()
    lm, batch = _lm(cfg), _smoke_batch(cfg, S=20)
    enc_len = 20 if cfg.is_encdec else 0
    state = init_decode_state(cfg, 2, 24, torch.float32, enc_len=enc_len,
                              device="cpu")
    state, _ = prefill(cfg, lm, state, batch)
    ref_layout = decode_state_to_numpy(state)
    # the reference's own layout, leaf for leaf
    ref = ref_init_decode_state(ref_get_arch(arch).reduced(), 2, 24, jnp.float32,
                                enc_len=enc_len)
    assert (jax.tree.structure(jax.tree.map(np.asarray, ref))
            == jax.tree.structure(ref_layout))
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(ref_layout)):
        assert a.shape == b.shape and a.dtype == b.dtype
    back = decode_state_from_numpy(ref_layout, device="cpu")
    assert back["t"] == state["t"] == 20
    for a, b in zip(jax.tree.leaves(back["caches"]), jax.tree.leaves(state["caches"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_window_schedule_matches_reference(arch):
    for cfg, ref_cfg in ((get_arch(arch), ref_get_arch(arch)),
                         (get_arch(arch).reduced(), ref_get_arch(arch).reduced())):
        ref = np.asarray(ref_win_schedule(ref_cfg))
        assert _win_schedule(cfg) == tuple(int(w) for w in ref)
    if arch == "hymba-1.5b":
        win = _win_schedule(get_arch(arch))
        assert [i for i, w in enumerate(win) if w == 0] == [0, 15, 31]


def test_pooled_features_bit_for_bit_through_the_dense_only_path():
    """Deep kernel learning's features on the reduced smollm through
    `forward_hidden` equal, bit for bit, the dense-only path it replaces,
    written out here from each block's weights."""
    cfg = get_arch("smollm-360m").reduced()
    lm = _lm(cfg, seed=7)
    tokens = torch.as_tensor(np.random.default_rng(8).integers(0, cfg.vocab, (3, 64)))
    h = lm.embed[tokens]
    pos = torch.arange(64, dtype=torch.int32)[None].expand(3, 64)
    with torch.no_grad():
        for blk in lm.blocks:
            xn = layers.apply_norm(cfg.norm, h, blk.ln1)
            q, k, v = qkv_proj(blk.attn, xn, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
            q = layers.apply_rope(q, pos, cfg.rope_theta)
            k = layers.apply_rope(k, pos, cfg.rope_theta)
            out = attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
            h = h + out.reshape(3, 64, -1) @ blk.attn["wo"]
            h = h + layers.mlp_apply(cfg.mlp, blk.mlp,
                                     layers.apply_norm(cfg.norm, h, blk.ln2))
        want = torch.mean(layers.apply_norm(cfg.norm, h, lm.final_norm), dim=1)
    got = pooled_features(cfg, lm, tokens, device="cpu")     # with autograd
    assert got.requires_grad
    assert torch.equal(got.detach(), want)
    with torch.no_grad():
        assert torch.equal(pooled_features(cfg, lm, tokens, device="cpu"), want)


# ---------------------------------------------------------------------------
# the launcher and the example
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,extra", (("hymba-1.5b", []),
                                        ("qwen2-vl-7b", ["--patches", "6"]),
                                        ("seamless-m4t-large-v2", [])))
def test_serve_launcher_on_cpu(arch, extra):
    from repro_torch.launch import serve

    rep = serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                      "--prompt-len", "20", "--gen", "5"] + extra)
    assert rep["arch"] == arch + "-smoke" and rep["device"] == "cpu"
    assert rep["tokens"].shape == (2, 5) and rep["logits"].shape[:2] == (2, 5)
    assert bool(torch.isfinite(rep["logits"]).all())
    assert rep["state"]["t"] == 24 and rep["decode_tokens"] == 8
    assert len(rep["step_ms"]) == 4 and rep["prefill_ms"] > 0
    assert rep["params"] == sum(p.numel() for p in rep["lm"].parameters())
    # greedy: each token is the argmax of the step's logits
    assert torch.equal(rep["tokens"], torch.argmax(rep["logits"], -1))
    if extra:
        assert rep["batch"]["embed_mask"][:, :6].all()
        assert not rep["batch"]["embed_mask"][:, 6:].any()


def test_serve_example_on_cpu(capsys):
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import serve_lm_torch
    finally:
        sys.path.remove(str(ROOT / "examples"))
    out = serve_lm_torch.main(["--device", "cpu", "--batch", "2",
                               "--prompt-len", "16", "--gen", "4"])
    assert out["tokens"].shape == (2, 4) and out["state"]["t"] == 19
    assert "sample generation" in capsys.readouterr().out


def test_serving_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("mamba2-130m").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_decode_state(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "mamba2-130m"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.make_batch(cfg, 1, 4)
