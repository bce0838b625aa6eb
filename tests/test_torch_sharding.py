"""The port's sharding rules (`repro_torch.models.sharding`) and layout
points (`repro_torch.models.shardctx`) against the reference's.

* For every LM arch at its FULL config, on a (16, 16) ("data", "model") and
  a (2, 16, 16) ("pod", "data", "model") production mesh, the port's
  `param_pspec` of every per-layer parameter equals the reference's
  `param_pspec` of the stacked leaf without its leading L entry (and the
  port's shapes are the reference's without L). Reference shapes come from
  `jax.eval_shape(init_params)`, the port's from the `meta` device: nothing
  is allocated. The reference's rules read only `mesh.axis_names` and
  `mesh.devices.shape`, so a stand-in object serves as the mesh on both
  sides.
* `batch_shardings` (train / prefill batches of every family),
  `token_sharding`, `logits_sharding` and `decode_state_shardings` (the
  decode_32k and long_500k caches, B = 1 included) compare the same way.
* `param_placements` turns specs into Shard / Replicate placements.
* `shardctx` is the identity with no mesh, and `use_mesh` nests.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.models.sharding as ref_sharding
from repro.launch.specs import cell_for as ref_cell_for
from repro.launch.specs import decode_specs as ref_decode_specs
from repro.launch.specs import input_specs as ref_input_specs
from repro.models import get_arch as ref_get_arch
from repro.models import init_params as ref_init_params
from repro.models import registry as ref_registry
from repro_torch.launch.specs import cell_for, decode_specs, input_specs
from repro_torch.models import LM, get_arch
from repro_torch.models import sharding, shardctx

LM_ARCHS = tuple(a for a in ref_registry.ARCH_IDS if a != "gp-exact-1m")


class StandInMesh:
    """What the rules read of a mesh: axis names and the devices' shape."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.zeros(shape, dtype=np.int8)


MESHES = {
    "16x16": StandInMesh((16, 16), ("data", "model")),
    "2x16x16": StandInMesh((2, 16, 16), ("pod", "data", "model")),
}


def _spec(p) -> tuple:
    return tuple(p)


@pytest.fixture
def bare_named_sharding(monkeypatch):
    """The reference wraps specs in NamedSharding, which needs a real jax
    mesh; return the spec itself instead."""
    monkeypatch.setattr(ref_sharding, "NamedSharding", lambda mesh, spec: spec)


def _ref_param_shapes(cfg) -> dict:
    tree = jax.eval_shape(lambda: ref_init_params(cfg, jax.random.PRNGKey(0)))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): tuple(l.shape) for p, l in flat}


def _ref_key(name: str):
    parts = name.split(".")
    stacked = parts[0] in ("blocks", "enc_blocks") and parts[1].isdigit()
    if stacked:
        parts = [parts[0]] + parts[2:]
    return "".join(f"['{p}']" for p in parts), stacked


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_pspec_matches_reference(arch, mesh_name):
    mesh = MESHES[mesh_name]
    ref_shapes = _ref_param_shapes(ref_get_arch(arch))
    lm = LM(get_arch(arch), device="meta")
    seen = set()
    n = 0
    for name, p in lm.named_parameters():
        key, stacked = _ref_key(name)
        ref_shape = ref_shapes[key]
        shape = tuple(p.shape)
        assert (ref_shape[1:] if stacked else ref_shape) == shape, name
        want = _spec(ref_sharding.param_pspec(mesh, key, ref_shape))
        if stacked and want:
            assert want[0] is None, (name, want)
            want = want[1:]
        assert sharding.param_pspec(mesh, name, shape) == want, (name, want)
        seen.add(key)
        n += 1
    assert seen == set(ref_shapes)           # every reference leaf covered
    specs = sharding.param_pspecs(mesh, lm)
    assert len(specs) == n
    # the production rules shard something on every mesh: FSDP and TP both
    # appear (a rule set that replicated everything would pass the above
    # only if the reference did too)
    flat = {a for s in specs.values() for e in s if e
            for a in ((e,) if isinstance(e, str) else e)}
    assert "model" in flat and "data" in flat


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_batch_token_logits_shardings_match_reference(
        arch, mesh_name, bare_named_sharding):
    mesh = MESHES[mesh_name]
    rcfg, cfg = ref_get_arch(arch), get_arch(arch)
    for shape in ("train_4k", "prefill_32k"):
        rb = ref_input_specs(rcfg, ref_cell_for(rcfg, shape))
        pb = input_specs(cfg, cell_for(cfg, shape))
        assert set(rb) == set(pb)
        want = {k: _spec(v) for k, v in
                ref_sharding.batch_shardings(mesh, rb).items()}
        assert sharding.batch_shardings(mesh, pb) == want
    for b in (128, 1, 7):
        assert sharding.token_sharding(mesh, b) == _spec(
            ref_sharding.token_sharding(mesh, b))
        assert sharding.logits_sharding(mesh, b, cfg.vocab) == _spec(
            ref_sharding.logits_sharding(mesh, b, rcfg.vocab))
    # positions (B, S) and M-RoPE's (3, B, S)
    pos = {"positions": np.zeros((3, 32, 64)), "other": np.zeros((4,))}
    want = {k: _spec(v) for k, v in ref_sharding.batch_shardings(mesh, pos).items()}
    assert sharding.batch_shardings(mesh, pos) == want
    assert sharding.batch_pspec(mesh) == _spec(ref_sharding.batch_pspec(mesh))
    for sp in (True, False):
        assert sharding.hidden_pspec(mesh, sp=sp) == _spec(
            ref_sharding.hidden_pspec(mesh, sp=sp))


def _ref_state_specs(mesh, rcfg, cell):
    state, _ = ref_decode_specs(rcfg, cell, dtype=jnp.bfloat16)
    specs = ref_sharding.decode_state_shardings(mesh, state)
    flat, _ = jax.tree_util.tree_flatten_with_path(specs)
    return {jax.tree_util.keystr(p): _spec(s) for p, s in flat}, state


def _walk(tree, parts=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, parts + (k,))
    else:
        yield parts, tree


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_state_shardings_match_reference(arch, mesh_name,
                                                bare_named_sharding):
    mesh = MESHES[mesh_name]
    rcfg, cfg = ref_get_arch(arch), get_arch(arch)
    shapes = ["decode_32k"] + (["long_500k"] if cfg.sub_quadratic else [])
    for shape in shapes:
        cell = cell_for(cfg, shape)
        ref_specs, ref_state = _ref_state_specs(mesh, rcfg, ref_cell_for(rcfg, shape))
        state, _ = decode_specs(cfg, cell)
        assert len(state["caches"]) == cfg.n_layers
        specs = sharding.decode_state_shardings(mesh, state)
        assert specs["t"] == ref_specs["['t']"] == ()
        for layer, cache in enumerate(specs["caches"]):
            for parts, spec in _walk(cache):
                key = "['caches']" + "".join(f"['{p}']" for p in parts)
                want = ref_specs[key]
                if want:
                    assert want[0] is None
                    want = want[1:]
                assert spec == want, (shape, layer, key, spec, want)
        if shape == "long_500k" and "k" in state["caches"][0]:
            # B = 1 does not divide fsdp: the cache LENGTH takes fsdp + model
            kspec = specs["caches"][0]["k"]
            assert kspec[0] is None and "model" in kspec[1]


def test_param_placements_and_specs_of_a_small_mesh():
    from torch.distributed.tensor import Replicate, Shard

    mesh = StandInMesh((2, 4), ("data", "model"))
    cfg = get_arch("smollm-360m")
    lm = LM(cfg, device="meta")
    pl = sharding.param_placements(mesh, lm)
    assert pl["embed"] == [Shard(1), Shard(0)]           # (V over model, D over data)
    assert pl["blocks.0.attn.wq"] == [Shard(0), Shard(1)]
    assert pl["blocks.0.attn.wo"] == [Shard(1), Shard(0)]
    assert pl["blocks.0.ln1"] == [Replicate(), Replicate()]
    # several axes on one dim, in mesh order
    m3 = StandInMesh((2, 2, 2), ("pod", "data", "model"))
    assert sharding.placements(m3, (None, ("pod", "data", "model")), 2) == [
        Shard(1), Shard(1), Shard(1)]
    assert sharding.placements(m3, (), 3) == [Replicate()] * 3


def test_fit_degrades_non_dividing_dims_to_replication():
    mesh = MESHES["16x16"]
    # seamless's 256206 vocab does not divide 16: the vocab dim replicates
    assert sharding.param_pspec(mesh, "embed", (256206, 1024)) == (None, "data")
    assert sharding.param_pspec(mesh, "embed", (49152, 960)) == ("model", "data")
    # mamba2's ragged in_proj keeps its columns whole
    assert sharding.param_pspec(mesh, "blocks.0.ssm.in_proj", (768, 3352)) == (
        "data", None)


def test_shardctx_identity_without_mesh():
    import torch

    x = torch.randn(2, 3, 4, 5)
    assert shardctx.current_mesh() is None
    assert shardctx.shard(x, "fsdp", None, "tp", None) is x
    assert shardctx.shard_hidden(x[..., 0]) is x[..., 0] or torch.equal(
        shardctx.shard_hidden(x[..., 0]), x[..., 0])
    assert shardctx.shard_heads(x) is x
    assert shardctx.gathered(x) is x
    assert shardctx.axis_size("model") == 1 and shardctx.axis_index("data") == 0
    out = shardctx.local(lambda a: a * 2, (x,), (("fsdp", None, None, None),),
                         ("fsdp", None, None, None))
    assert torch.equal(out, x * 2)
    mesh = MESHES["16x16"]
    with shardctx.use_mesh(mesh):
        assert shardctx.current_mesh() is mesh
        assert shardctx.resolve(mesh, ("fsdp", None, "tp")) == ("data", None, "model")
        # a plain tensor under a mesh is left alone
        assert shardctx.shard(x, "fsdp", None, "tp", None) is x
        with shardctx.use_mesh(None):
            assert shardctx.current_mesh() is None
        assert shardctx.current_mesh() is mesh
    assert shardctx.current_mesh() is None
    m3 = MESHES["2x16x16"]
    assert shardctx.resolve(m3, ("fsdp", "tp")) == (("pod", "data"), "model")
