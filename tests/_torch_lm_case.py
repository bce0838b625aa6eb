"""Shared case of the LM family parity tests (`tests/test_torch_lm_*.py`).

`lm_case(arch)` runs one reduced config through both packages on the same
inputs: weights from the reference's `init_params(cfg.reduced(),
PRNGKey(0), float32)` carried across by `lm_params_from_numpy`, a seeded
numpy batch of B 2 x S 64 (the reference smoke test's shapes: encoder
frames for enc-dec, patch embeddings on the first 8 positions for vlm).
It returns, per package, `forward_hidden`'s h and aux, `train_loss` with
its metrics and every leaf's gradient, `prefill` of the first S - 4
tokens (logits and the decode state in the reference's layout), and 3
decode steps (logits and state after each).

Tolerances (the conformance ones, `tests/test_conformance.py:61`): arrays
within 2e-4 of their largest entry, scalars within 3e-5 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import get_arch as ref_get_arch
from repro.models import init_params as ref_init_params
from repro.models.model import decode_step as ref_decode_step
from repro.models.model import forward_hidden as ref_forward_hidden
from repro.models.model import init_decode_state as ref_init_decode_state
from repro.models.model import prefill as ref_prefill
from repro.models.model import train_loss as ref_train_loss
from repro_torch.interop import decode_state_to_numpy, lm_params_from_numpy
from repro_torch.models import (
    decode_step, forward_hidden, get_arch, init_decode_state, prefill, train_loss)

MAT_TOL = 2e-4
VAL_TOL = 3e-5
B, S = 2, 64
PROMPT = S - 4
DECODE_STEPS = 3


def close(a, b, tol=MAT_TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


def scalar_close(a, b, tol=VAL_TOL):
    a, b = float(a), float(b)
    assert abs(a - b) <= tol * abs(b), (a, b)


def numpy_batch(cfg, seed=5):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)),
             "targets": rng.integers(0, cfg.vocab, size=(B, S))}
    if cfg.is_encdec:
        batch["enc_embeds"] = (0.1 * rng.normal(size=(B, S, cfg.d_model))
                               ).astype(np.float32)
    if cfg.family == "vlm":
        batch["embeds"] = (0.1 * rng.normal(size=(B, S, cfg.d_model))
                           ).astype(np.float32)
        mask = np.zeros((B, S), bool)
        mask[:, :8] = True
        batch["embed_mask"] = mask
    return batch


def prompt_of(batch):
    return {k: (v[:, :PROMPT] if k in ("tokens", "embeds", "embed_mask") else v)
            for k, v in batch.items() if k != "targets"}


def state_leaves(state):
    """{path: array} of a decode state in the reference's layout."""
    flat = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, state))
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


@functools.lru_cache(maxsize=None)
def lm_case(arch):
    ref_cfg = ref_get_arch(arch).reduced()
    cfg = get_arch(arch).reduced()
    params = ref_init_params(ref_cfg, jax.random.PRNGKey(0), jnp.float32)
    batch = numpy_batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    enc_len = S if cfg.is_encdec else 0
    tokens = batch["tokens"]

    ref = {}
    ref["h"], ref["aux"] = ref_forward_hidden(ref_cfg, params, jb)
    (ref["loss"], ref["metrics"]), grads = jax.value_and_grad(
        lambda p: ref_train_loss(ref_cfg, p, jb), has_aux=True)(params)
    ref["grads"] = jax.tree.map(np.asarray, grads)
    st = ref_init_decode_state(ref_cfg, B, S, jnp.float32, enc_len=enc_len)
    st, ref["prefill_logits"] = ref_prefill(
        ref_cfg, params, st, {k: jnp.asarray(v) for k, v in prompt_of(batch).items()})
    ref["prefill_state"] = state_leaves(st)
    ref["decode"] = []
    for i in range(DECODE_STEPS):
        st, logits = ref_decode_step(ref_cfg, params, st,
                                     jnp.asarray(tokens[:, PROMPT + i]))
        ref["decode"].append((np.asarray(logits), state_leaves(st)))

    lm = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params), "cpu")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    port = {}
    with torch.no_grad():
        port["h"], port["aux"] = forward_hidden(cfg, lm, tb)
    port["loss"], port["metrics"] = train_loss(cfg, lm, tb)
    port["loss"].backward()
    port["grads"] = {name: (torch.zeros_like(p) if p.grad is None else p.grad)
                     for name, p in lm.named_parameters()}
    st = init_decode_state(cfg, B, S, torch.float32, enc_len=enc_len, device="cpu")
    st, port["prefill_logits"] = prefill(
        cfg, lm, st, {k: torch.as_tensor(v) for k, v in prompt_of(batch).items()})
    port["prefill_state"] = state_leaves(decode_state_to_numpy(st))
    port["decode"] = []
    for i in range(DECODE_STEPS):
        st, logits = decode_step(cfg, lm, st, torch.as_tensor(tokens[:, PROMPT + i]))
        port["decode"].append((logits, state_leaves(decode_state_to_numpy(st))))
    return cfg, ref, port


# ---------------------------------------------------------------------------
# the checks each family file parametrizes over its archs
# ---------------------------------------------------------------------------


def check_forward_hidden(arch):
    cfg, ref, port = lm_case(arch)
    assert port["h"].dtype == torch.float32
    close(port["h"], ref["h"])
    if cfg.family == "moe":
        scalar_close(port["aux"], ref["aux"])
        assert float(port["aux"]) > 0
    else:
        assert float(port["aux"]) == float(ref["aux"]) == 0.0


def check_train_loss(arch):
    cfg, ref, port = lm_case(arch)
    scalar_close(port["loss"].detach(), ref["loss"])
    scalar_close(port["metrics"]["ce"].detach(), ref["metrics"]["ce"])
    if cfg.family == "moe":
        scalar_close(port["metrics"]["moe_aux"].detach(), ref["metrics"]["moe_aux"])
    else:
        assert float(port["metrics"]["moe_aux"]) == 0.0


def check_grads(arch):
    """Every leaf, layer by layer (the encoder's too); a leaf the loss does
    not reach takes a zero gradient on both sides."""
    from repro_torch.interop import lm_reference_leaf

    _, ref, port = lm_case(arch)
    # one reference leaf per stacked name: blocks.<i>.<key> -> blocks.<key>
    stacked = {".".join(p[:1] + p[2:]) if p[0] in ("blocks", "enc_blocks")
               else ".".join(p) for p in (n.split(".") for n in port["grads"])}
    assert len(stacked) == len(jax.tree.leaves(ref["grads"]))
    for name, g in port["grads"].items():
        want = lm_reference_leaf(ref["grads"], name)
        if not np.abs(want).max():
            assert not torch.any(g), name
            continue
        close(g, want)


def check_prefill(arch):
    _, ref, port = lm_case(arch)
    close(port["prefill_logits"], ref["prefill_logits"])
    assert set(port["prefill_state"]) == set(ref["prefill_state"])
    for key, want in ref["prefill_state"].items():
        if key == "['t']":
            assert int(port["prefill_state"][key]) == int(want) == PROMPT
        else:
            close(port["prefill_state"][key], want)


def check_decode(arch):
    _, ref, port = lm_case(arch)
    for i, ((logits, st), (ref_logits, ref_st)) in enumerate(
            zip(port["decode"], ref["decode"])):
        close(logits, ref_logits)
        assert int(st["['t']"]) == int(ref_st["['t']"]) == PROMPT + i + 1
        for key, want in ref_st.items():
            if key != "['t']":
                close(st[key], want)
