"""The aten ops one LM decode step dispatches, per family, on the CPU:

    python3 scripts/decode_ops.py <tree> [--out ops.json]

Each family's registry config at its published depth and the reduced
config's widths, fp32, batch 2; after one warm-up step, a
`TorchDispatchMode` counts the ops of the next decode step. Run it on two
trees (e.g. a `git archive` of the parent under `build/`) and compare the
files: equal counts mean the two trees give the card the same work, so a
decode-speed gap between them is the host's.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

ARCHS = ("smollm-360m", "qwen2-moe-a2.7b", "mamba2-130m", "hymba-1.5b",
         "seamless-m4t-large-v2", "qwen2-vl-7b")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("tree")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import decode_step, get_arch, init_decode_state, init_params

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, fargs=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*fargs, **(kwargs or {}))

    torch.set_num_threads(1)
    out = {}
    for arch in ARCHS:
        full = get_arch(arch)
        cfg = full.reduced()._replace(n_layers=full.n_layers,
                                      n_enc_layers=full.n_enc_layers)
        lm = init_params(cfg, torch.Generator().manual_seed(0),
                         dtype=torch.float32, device="cpu")
        state = init_decode_state(cfg, 2, 64, torch.float32,
                                  enc_len=8 if cfg.is_encdec else 0, device="cpu")
        tok = torch.zeros(2, dtype=torch.long)
        with torch.no_grad():
            state, _ = decode_step(cfg, lm, state, tok)
            with Count() as c:
                decode_step(cfg, lm, state, tok)
        out[arch] = dict(sorted(c.ops.items()))
        print(f"{arch}: {sum(c.ops.values())} ops a decode step, "
              f"{len(c.ops)} kinds", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
