"""The port's LM stack (`repro_torch.models`, `repro_torch.configs`) against
the reference on the CPU in fp32.

* Configs: the 10 LM configs and gp-exact-1m equal the reference's field
  for field (and so do their `reduced()` variants and derived properties);
  the registry has the same ids.
* Layers: rmsnorm, np_layernorm, the (Sw)iGLU / GeLU MLPs, split-half RoPE,
  `_repeat_kv` (consecutive repeats) and the query-chunked attention
  (causal, sliding window, ragged chunks, a query offset; values and
  gradients through the checkpointed chunks).
* The model: `forward_hidden`, `train_loss` and every leaf's `train_loss`
  gradient on smollm-360m.reduced() and olmo-1b.reduced() at B 2, S 64,
  attn_chunk 32 (two query chunks per layer), weights made by the
  reference's `init_params(cfg, PRNGKey(0), float32)` and carried across
  by `lm_params_from_numpy`.
* Counts: `count_params` / `count_active_params` of all 10 full LM
  configs equal the reference's (`jax.eval_shape` there, the `meta` device
  here); an unknown family raises. The other families' parity tests are
  `tests/test_torch_lm_*.py`.

Tolerances (the conformance ones, `tests/test_conformance.py:61`): arrays
within 2e-4 of their largest entry, scalars within 3e-5 relative.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import count_active_params as ref_count_active
from repro.models import count_params as ref_count
from repro.models import forward_hidden as ref_forward_hidden
from repro.models import get_arch as ref_get_arch
from repro.models import init_params as ref_init_params
from repro.models import layers as ref_layers
from repro.models import registry as ref_registry
from repro.models import train_loss as ref_train_loss
from repro.models.attention import _repeat_kv as ref_repeat_kv
from repro.models.attention import attention as ref_attention
from repro_torch.interop import lm_params_from_numpy, lm_reference_leaf
from repro_torch.models import (
    LM, count_active_params, count_params, forward_hidden, get_arch,
    list_archs, train_loss)
from repro_torch.models import layers
from repro_torch.models.attention import _repeat_kv, attention

MAT_TOL = 2e-4
VAL_TOL = 3e-5
LM_ARCHS = tuple(a for a in ref_registry.ARCH_IDS if a != "gp-exact-1m")
REDUCED = ("smollm-360m", "olmo-1b")


def _close(a, b, tol=MAT_TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


# ---------------------------------------------------------------------------
# configs and registry
# ---------------------------------------------------------------------------


def test_registry_has_the_reference_ids():
    assert list_archs() == ref_registry.list_archs()
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


@pytest.mark.parametrize("arch", ref_registry.ARCH_IDS)
def test_config_matches_reference(arch):
    port, ref = get_arch(arch), ref_get_arch(arch)
    assert type(port).__module__.startswith("repro_torch.")
    assert port._fields == ref._fields
    assert port._asdict() == ref._asdict()
    if arch in LM_ARCHS:
        for prop in ("hd", "is_encdec", "sub_quadratic", "d_inner", "ssm_heads"):
            assert getattr(port, prop) == getattr(ref, prop), prop
        assert port.reduced()._asdict() == ref.reduced()._asdict()
        assert (port.reduced(n_layers=3, d_model=32)._asdict()
                == ref.reduced(n_layers=3, d_model=32)._asdict())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_counts_match_reference(arch):
    cfg = get_arch(arch)
    assert count_params(cfg) == ref_count(ref_get_arch(arch))
    assert count_active_params(cfg) == ref_count_active(ref_get_arch(arch))


def test_unknown_family_raises():
    cfg = get_arch("smollm-360m").reduced(family="rnn")
    with pytest.raises(ValueError, match="'rnn'"):
        LM(cfg, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        count_params(cfg)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


@pytest.mark.parametrize("kind", ("rmsnorm", "np_layernorm"))
def test_norm_matches_reference(kind):
    rng = np.random.default_rng(0)
    x = _rand(rng, 3, 5, 64, scale=3.0) + 1.5
    scale = _rand(rng, 64) + 1.0
    ref = ref_layers.apply_norm(kind, jnp.asarray(x), jnp.asarray(scale))
    out = layers.apply_norm(kind, torch.as_tensor(x), torch.as_tensor(scale))
    _close(out, ref)


def test_rmsnorm_casts_back_after_the_scale():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(_rand(rng, 4, 32)).to(torch.bfloat16)
    scale = torch.as_tensor(_rand(rng, 32)).to(torch.bfloat16)
    out = layers.rmsnorm(x, scale)
    assert out.dtype == torch.bfloat16
    x32 = x.float()
    want = (x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + 1e-6)
            * scale.float()).to(torch.bfloat16)
    assert torch.equal(out, want)


@pytest.mark.parametrize("kind", ("swiglu", "gelu"))
def test_mlp_matches_reference(kind):
    rng = np.random.default_rng(2)
    p = layers.mlp_params(kind, torch.Generator().manual_seed(0), 16, 40,
                          torch.float32, "cpu")
    assert set(p) == ({"wi", "wo", "wg"} if kind == "swiglu" else {"wi", "wo"})
    x = _rand(rng, 2, 7, 16)
    ref_p = {k: jnp.asarray(v.detach().numpy()) for k, v in p.items()}
    ref = ref_layers.mlp_apply(kind, ref_p, jnp.asarray(x))
    _close(layers.mlp_apply(kind, p, torch.as_tensor(x)), ref)


@pytest.mark.parametrize("theta", (1e6, 1e4))
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 9, 3, 16)
    pos = (5 + np.arange(9, dtype=np.int32))[None].repeat(2, 0)
    ref = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    out = layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    _close(out, ref)
    # split-half: lane j pairs with lane j + hd/2 (rotating the pair keeps
    # its norm), not with its neighbour
    xr = out.numpy()
    np.testing.assert_allclose(xr[..., :8] ** 2 + xr[..., 8:] ** 2,
                               x[..., :8] ** 2 + x[..., 8:] ** 2, rtol=1e-5)


def test_repeat_kv_repeats_each_head_consecutively():
    k = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    out = _repeat_kv(torch.as_tensor(k), 3).numpy()
    np.testing.assert_array_equal(out, np.repeat(k, 3, axis=2))
    np.testing.assert_array_equal(out, np.asarray(ref_repeat_kv(jnp.asarray(k), 3)))


ATTN_CASES = (
    # (causal, window, chunk, sq, sk, q_offset)
    (True, 0, 8, 20, 20, 0),      # ragged: the last chunk padded by 4
    (True, 5, 8, 16, 16, 0),      # sliding window
    (False, 0, 6, 12, 12, 0),     # no mask (an encoder's)
    (True, 0, 8, 13, 16, 3),      # prefill continuation
    (True, 0, 64, 16, 16, 0),     # one chunk
)


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "c{}w{}k{}q{}s{}o{}".format(*c))
def test_attention_matches_reference(case):
    """GQA (6 query heads on 2 KV heads): values and the gradients with
    respect to q, k and v, through the per-chunk checkpoints."""
    causal, window, chunk, sq, sk, q_offset = case
    rng = np.random.default_rng(4)
    q, k, v = (_rand(rng, 2, sq, 6, 8), _rand(rng, 2, sk, 2, 8),
               _rand(rng, 2, sk, 2, 8))
    w = _rand(rng, 2, sq, 6, 8)
    kw = dict(causal=causal, window=window, chunk=chunk, q_offset=q_offset)

    def ref_fn(q, k, v):
        return jnp.sum(ref_attention(q, k, v, **kw) * w)

    ref_out = ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    ref_g = jax.grad(ref_fn, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                                jnp.asarray(v))
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = attention(qt, kt, vt, **kw)
    torch.sum(out * torch.as_tensor(w)).backward()
    _close(out, ref_out)
    for a, b in zip((qt.grad, kt.grad, vt.grad), ref_g):
        _close(a, b)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lm_case(arch):
    """Both packages' hidden states, loss and gradients on one batch."""
    ref_cfg = ref_get_arch(arch).reduced()
    cfg = get_arch(arch).reduced()
    assert cfg.attn_chunk == 32
    params = ref_init_params(ref_cfg, jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, size=(2, 64))
    targets = rng.integers(0, cfg.vocab, size=(2, 64))
    batch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
    ref_h, _ = ref_forward_hidden(ref_cfg, params, batch)
    (ref_loss, _), ref_grads = jax.value_and_grad(
        lambda p: ref_train_loss(ref_cfg, p, batch), has_aux=True)(params)

    lm = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params), "cpu")
    tb = {"tokens": torch.as_tensor(tokens), "targets": torch.as_tensor(targets)}
    with torch.no_grad():
        h, _ = forward_hidden(cfg, lm, tb)
    loss, metrics = train_loss(cfg, lm, tb)
    loss.backward()
    grads = {name: (torch.zeros_like(p) if p.grad is None else p.grad)
             for name, p in lm.named_parameters()}
    ref_grads = jax.tree.map(np.asarray, ref_grads)
    return (np.asarray(ref_h), float(ref_loss), ref_grads), (h, loss, metrics, grads)


@pytest.mark.parametrize("arch", REDUCED)
def test_forward_hidden_matches_reference(arch):
    (ref_h, _, _), (h, _, _, _) = _lm_case(arch)
    assert h.dtype == torch.float32
    _close(h, ref_h)


@pytest.mark.parametrize("arch", REDUCED)
def test_train_loss_matches_reference(arch):
    (_, ref_loss, _), (_, loss, metrics, _) = _lm_case(arch)
    assert abs(float(loss.detach()) - ref_loss) <= VAL_TOL * abs(ref_loss)
    assert float(metrics["moe_aux"]) == 0.0
    assert float(metrics["ce"]) == float(loss)


@pytest.mark.parametrize("arch", REDUCED)
def test_train_loss_grads_match_reference(arch):
    """Every leaf, layer by layer (OLMo's dummy norm parameters take a zero
    gradient on both sides)."""
    (_, _, ref_grads), (_, _, _, grads) = _lm_case(arch)
    cfg = get_arch(arch).reduced()
    assert len(grads) == 2 + cfg.n_layers * len(
        [k for k in grads if k.startswith("blocks.0.")])
    for name, g in grads.items():
        ref = lm_reference_leaf(ref_grads, name)
        if not np.abs(ref).max():
            assert not torch.any(g), name
            continue
        _close(g, ref)


def test_remat_changes_nothing():
    """Per-block checkpointing (cfg.remat) recomputes the same values: the
    gradients with and without it are equal bit for bit."""
    cfg = get_arch("smollm-360m").reduced(n_layers=2)
    rng = np.random.default_rng(6)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 64))),
             "targets": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 64)))}
    out = []
    for remat in (True, False):
        c = cfg._replace(remat=remat)
        lm = LM(c, torch.Generator().manual_seed(0), torch.float32, "cpu")
        train_loss(c, lm, batch)[0].backward()
        out.append([p.grad.clone() for p in lm.parameters()])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_lm_init_is_seeded_and_bf16_by_default():
    cfg = get_arch("smollm-360m").reduced()
    a = LM(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = LM(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert a.embed.dtype == torch.bfloat16
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
    assert count_params(cfg, a) == count_params(cfg)
