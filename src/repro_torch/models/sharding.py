"""Sharding rules: parameter specs, batch / activation / cache specs, and
their DTensor placements.

The counterpart of `repro.models.sharding`, with the reference's layout on
the production mesh (pod, data, model):
  * FSDP: the d_model dim of every weight shards over ("pod", "data"),
    except norms / router / SSM scalars (`_REPLICATED_KEYS`).
  * TP:   heads / ff-hidden / vocab dims shard over "model".
  * Batch shards over ("pod", "data"); the residual stream additionally
    shards its sequence dim over "model" between blocks (`hidden_pspec`).
  * KV caches: batch over ("pod", "data"), cache length over "model"; when
    the batch does not divide the fsdp axes (long_500k: B = 1) the cache
    length takes both instead.

A spec is a tuple with one entry per tensor dim: None, an axis name, or a
tuple of axis names (the reference's `PartitionSpec` entries, so the two
compare entry for entry). `_fit` drops an axis set that does not divide its
dim, as the reference's does (seamless's 256206 vocab, mamba2's ragged
`in_proj`).

The port's layers are separate modules: `blocks.<i>.attn.wq` is layer i of
the reference's stacked `['blocks']['attn']['wq']` (leading L axis). Every
rule here is the reference's rule evaluated on the stacked path and shape,
and the per-layer spec is the stacked one without its leading (None) entry.
The same holds for the per-layer decode caches. `param_placements` turns a
spec into `Shard` / `Replicate` placements on the mesh's `DeviceMesh`.
"""

from __future__ import annotations

import math

FSDP = ("pod", "data")   # the present subset is used
TP = "model"

_REPLICATED_KEYS = ("ln1", "ln2", "ln_cross", "final_norm", "enc_norm",
                    "norm_scale", "A_log", "dt_bias", "conv_w", "conv_b",
                    "router")
_STACKED = ("blocks", "enc_blocks")


def _sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, tuple(mesh.devices.shape)))


def _axes(mesh, want):
    if isinstance(want, str):
        want = (want,)
    got = tuple(a for a in want if a in mesh.axis_names)
    if not got:
        return None
    return got if len(got) > 1 else got[0]


def _axes_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _sizes(mesh)
    return int(math.prod(sizes[a] for a in axes))


def _fit(mesh, shape, *wants) -> tuple:
    """A spec for `shape`, dropping axes that do not divide their dim."""
    spec = []
    for dim, want in zip(shape, wants):
        axes = None if want is None else _axes(mesh, want)
        if axes is None or dim % _axes_size(mesh, axes) != 0:
            spec.append(None)
        else:
            spec.append(axes)
    return tuple(spec)


def _keystr(parts) -> str:
    return "".join(f"['{p}']" for p in parts)


def _stacked(name: str, shape):
    """The reference's keystr and stacked shape for a port name: the layer
    index after `blocks` / `enc_blocks` goes, and the shape gains a leading
    L (1 here: no rule reads its size). Returns (keystr, shape, stacked)."""
    parts = name.split(".")
    if len(parts) > 1 and parts[0] in _STACKED and parts[1].isdigit():
        return _keystr([parts[0]] + parts[2:]), (1,) + tuple(shape), True
    return _keystr(parts), tuple(shape), False


def _ref_param_pspec(mesh, path: str, shape) -> tuple:
    """The reference's rule on its keystr path and (stacked) shape."""
    ndim = len(shape)
    if "embed" in path:
        return _fit(mesh, shape, TP, FSDP)                 # (V, D)
    if any(f"'{k}'" in path for k in _REPLICATED_KEYS) or path.endswith("['D']"):
        return ()
    lead = (None,) if ndim >= 3 else ()

    def fit(*wants):
        return _fit(mesh, shape, *(lead + wants))

    if "shared" in path:       # MoE shared-expert MLP (rank 3, check first)
        if "'wo'" in path:
            return fit(TP, FSDP)                           # (L, Fs, D)
        return fit(FSDP, TP)                               # (L, D, Fs)
    if "moe" in path:
        if "'wo'" in path:
            return _fit(mesh, shape, None, None, TP, FSDP)  # (L, E, Fe, D)
        return _fit(mesh, shape, None, None, FSDP, TP)      # (L, E, D, Fe)
    if "attn" in path or "cross" in path:
        if "'wo'" in path:
            return fit(TP, FSDP)                           # (L, H*hd, D)
        return fit(FSDP, TP)                               # (L, D, H*hd|kv*hd)
    if "in_proj" in path:
        # column layout [z|x|B|C|dt] is ragged: keep columns whole, shard
        # the d_model rows over fsdp
        return fit(FSDP, None)                             # (L, D, proj)
    if "out_proj" in path:
        return fit(TP, FSDP)                               # (L, dinner, D)
    if "'wi'" in path or "'wg'" in path:
        return fit(FSDP, TP)                               # (L, D, F)
    if "'wo'" in path:
        return fit(TP, FSDP)                               # (L, F, D)
    return ()


def param_pspec(mesh, path: str, shape) -> tuple:
    """The spec of parameter `path` (a port name, `blocks.3.mlp.wi`) of
    per-layer `shape`: the reference's spec of the stacked leaf without
    its leading L entry. `()` is replicated."""
    key, full, stacked = _stacked(path, shape)
    spec = _ref_param_pspec(mesh, key, full)
    return spec[1:] if stacked and spec else spec


def param_pspecs(mesh, lm) -> dict:
    """{parameter name: spec} for every parameter of `lm`."""
    return {name: param_pspec(mesh, name, tuple(p.shape))
            for name, p in lm.named_parameters()}


def placements(mesh, spec, ndim: int) -> list:
    """DTensor placements, one per mesh axis, for a spec over `ndim` dims:
    an axis named in dim j's entry shards dim j; the rest replicate. Axes
    of one entry are listed in mesh order, so the shards nest as the
    reference's (major to minor)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.axis_names]
    for dim, entry in enumerate(tuple(spec) + (None,) * (ndim - len(spec))):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            out[mesh.axis_names.index(a)] = Shard(dim)
    return out


def param_placements(mesh, lm) -> dict:
    """{parameter name: placements on `mesh.device_mesh`} for `lm`."""
    return {name: placements(mesh, param_pspec(mesh, name, tuple(p.shape)),
                             p.ndim)
            for name, p in lm.named_parameters()}


def param_shardings(mesh, lm) -> dict:
    """The reference's name for `param_placements`: {parameter name:
    placements on `mesh.device_mesh`}."""
    return param_placements(mesh, lm)


def distribute_lm(mesh, lm):
    """Replace every parameter of `lm` by a DTensor on `mesh.device_mesh`
    laid out by `param_placements`; each rank keeps its own shard, taken
    from its full copy without communication. A parameter on the `meta`
    device becomes an empty tensor on the mesh's device first (under
    `FakeTensorMode`, a fake one: shapes only). Returns `lm`."""
    import torch
    from torch import nn
    from torch.distributed.tensor import distribute_tensor

    dm = mesh.device_mesh
    for name, pl in param_placements(mesh, lm).items():
        mod_name, _, leaf = name.rpartition(".")
        mod = lm.get_submodule(mod_name) if mod_name else lm
        p = mod[leaf] if isinstance(mod, nn.ParameterDict) else getattr(mod, leaf)
        full = p.detach()
        if full.device.type == "meta":
            full = torch.empty(full.shape, dtype=full.dtype, device=mesh.device)
        d = nn.Parameter(distribute_tensor(full, dm, pl, src_data_rank=None),
                         requires_grad=p.requires_grad)
        if isinstance(mod, nn.ParameterDict):
            mod[leaf] = d
        else:
            setattr(mod, leaf, d)
    return lm


# ---------------------------------------------------------------------------
# activation / batch / state specs
# ---------------------------------------------------------------------------


def batch_pspec(mesh) -> tuple:
    return (_axes(mesh, FSDP),)


def hidden_pspec(mesh, *, sp: bool = True) -> tuple:
    """(B, S, D) residual stream: batch over fsdp, seq over model (SP)."""
    return (_axes(mesh, FSDP), _axes(mesh, TP) if sp else None, None)


def batch_shardings(mesh, batch_specs: dict) -> dict:
    """Specs for an input-batch dict (tokens / targets / embeds / ...) of
    tensors or anything with a `.shape`."""
    out = {}
    for k, v in batch_specs.items():
        shape = tuple(v.shape)
        if k in ("tokens", "targets", "embed_mask"):
            out[k] = _fit(mesh, shape, FSDP, None)
        elif k in ("embeds", "enc_embeds"):
            out[k] = _fit(mesh, shape, FSDP, TP, None)
        elif k == "positions":
            nd = len(shape)
            out[k] = _fit(mesh, shape, *([None] * (nd - 2)), FSDP, None)
        else:
            out[k] = ()
    return out


def token_sharding(mesh, batch: int) -> tuple:
    return _fit(mesh, (batch,), FSDP)


def logits_sharding(mesh, batch: int, vocab: int) -> tuple:
    return _fit(mesh, (batch, vocab), FSDP, TP)


def _ref_state_rule(mesh, key: str, shape) -> tuple:
    """The reference's cache rule on its keystr and stacked shape."""
    if any(f"'{k}'" in key for k in ("k", "v", "ck", "cv")):
        b = shape[1]
        if b % _axes_size(mesh, _axes(mesh, FSDP) or ()) == 0:
            return _fit(mesh, shape, None, FSDP, TP, None, None)
        return _fit(mesh, shape, None, None, FSDP + (TP,), None, None)
    if "'conv'" in key:
        return _fit(mesh, shape, None, FSDP, None, None)
    if "'ssm'" in key:
        return _fit(mesh, shape, None, FSDP, None, None, None)
    return ()


def decode_state_shardings(mesh, state) -> dict:
    """Specs for the port's decode state (`init_decode_state`): the same
    tree, `caches` a list of per-layer dicts whose leaves get the
    reference's stacked rule without the L entry, `t` replicated (`()`).
    KV caches (B, S, kv, hd): batch over fsdp and length over model; if B
    does not divide fsdp (long_500k, B = 1) the length takes fsdp + model.
    Recurrent SSM / conv states shard the batch only."""

    def walk(node, parts):
        if isinstance(node, dict):
            return {k: walk(v, parts + [k]) for k, v in node.items()}
        shape = (1,) + tuple(node.shape)
        spec = _ref_state_rule(mesh, _keystr(parts), shape)
        return spec[1:] if spec else spec

    return {"caches": [walk(c, ["caches"]) for c in state["caches"]],
            "t": ()}
