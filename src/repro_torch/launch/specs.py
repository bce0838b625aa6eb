"""Input specs for every (arch x shape) dry-run cell: shapes and dtypes,
no allocation.

The counterpart of `repro.launch.specs`. Shapes:
    train_4k     seq 4,096   global_batch 256   -> train step
    prefill_32k  seq 32,768  global_batch 32    -> prefill (serve)
    decode_32k   seq 32,768  global_batch 128   -> decode step (1 new token,
                                                   KV cache of seq_len)
    long_500k    seq 524,288 global_batch 1     -> decode step; only for
                                                   sub-quadratic archs
                                                   (ssm / hybrid)

Where the reference returns `jax.ShapeDtypeStruct`s, the port returns
tensors on the `meta` device (or on another device given, such as a fake
one under `FakeTensorMode`): shapes and dtypes, no storage. The decode
state is the port's `init_decode_state` on that device, one cache per
layer where the reference stacks them. [audio] / [vlm] frontends are stubs:
specs carry precomputed frame / patch embeddings.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


class Cell(NamedTuple):
    arch: str
    shape: str
    kind: str       # train | prefill | decode | gp_train | gp_predict
    batch: int
    seq: int
    skip: str = ""  # non-empty => the cell is skipped, with the reason


def cell_for(cfg, shape_name: str) -> Cell:
    s = SHAPES[shape_name]
    skip = ""
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        skip = "pure full-attention arch: 524k context is out of scope per assignment"
    return Cell(arch=cfg.name, shape=shape_name, kind=s["kind"],
                batch=s["batch"], seq=s["seq"], skip=skip)


def _tok(b, s, device):
    return torch.empty((b, s), dtype=torch.int32, device=device)


def input_specs(cfg, cell: Cell, *, dtype=torch.bfloat16, device="meta") -> dict:
    """The batch of a train / prefill cell as empty tensors on `device`."""
    b, s = cell.batch, cell.seq
    batch = {"tokens": _tok(b, s, device)}
    if cell.kind == "train":
        batch["targets"] = _tok(b, s, device)
    if cfg.is_encdec:
        # [audio] stub: precomputed frame embeddings for the encoder
        batch["enc_embeds"] = torch.empty((b, s, cfg.d_model), dtype=dtype,
                                          device=device)
    if cfg.family == "vlm":
        # [vlm] stub: patch embeddings override masked token positions
        batch["embeds"] = torch.empty((b, s, cfg.d_model), dtype=dtype,
                                      device=device)
        batch["embed_mask"] = torch.empty((b, s), dtype=torch.bool,
                                          device=device)
    return batch


def decode_specs(cfg, cell: Cell, *, dtype=torch.bfloat16, device="meta"):
    """(state, tokens) for a decode cell: a KV cache of seq_len, on
    `device`, and (batch,) int32 tokens."""
    state = init_decode_state_spec(cfg, cell.batch, cell.seq, dtype, device)
    tok = torch.empty((cell.batch,), dtype=torch.int32, device=device)
    return state, tok


def init_decode_state_spec(cfg, batch, max_seq, dtype, device="meta"):
    from repro_torch.models.model import init_decode_state

    enc_len = max_seq if cfg.is_encdec else 0
    return init_decode_state(cfg, batch, max_seq, dtype, enc_len=enc_len,
                             device=device)


def gp_cells(gp_cfg) -> list:
    return [
        Cell(arch=gp_cfg.name, shape="train_1m", kind="gp_train",
             batch=gp_cfg.n, seq=gp_cfg.d),
        Cell(arch=gp_cfg.name, shape="predict_1m", kind="gp_predict",
             batch=gp_cfg.n, seq=gp_cfg.d),
    ]


def gp_input_specs(gp_cfg, device="meta"):
    return {
        "X": torch.empty((gp_cfg.n, gp_cfg.d), dtype=torch.float32, device=device),
        "y": torch.empty((gp_cfg.n,), dtype=torch.float32, device=device),
    }
