"""Serving example on the PyTorch port: batched prefill + token-by-token
greedy decode with KV caches (and SSD states) written in place.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch hymba-1.5b
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

The counterpart of `examples/serve_lm.py`, on the family's reduced config
with fp32 weights from a seeded generator. Runs on the card unless
`--device cpu`.
"""

import argparse

import torch

from repro_torch.launch.serve import generate, make_batch
from repro_torch.models import get_arch, init_params


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' on purpose)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).reduced()
    # weights from a generator on the LM's device seeded 0
    lm = init_params(cfg, dtype=torch.float32, device=args.device)
    batch = make_batch(cfg, args.batch, args.prompt_len, device=lm.embed.device)
    out = generate(cfg, lm, batch, args.gen)
    print(f"prefill({args.prompt_len} tok x {args.batch}): "
          f"{out['prefill_ms']:.0f} ms")
    print(f"decode: {out['decode_tokens']} tokens in {out['decode_s']:.2f}s "
          f"({out['tokens_per_s']:.0f} tok/s)")
    print("sample generation (ids):", out["tokens"][0, :16].tolist())
    return out


if __name__ == "__main__":
    main()
