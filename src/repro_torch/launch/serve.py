"""Serving launcher: batched prefill + greedy decode for any --arch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
        --batch 4 --prompt-len 64 --gen 32 [--full] [--device cpu]

The counterpart of `repro.launch.serve`: fp32 weights from a seeded
generator (the reference loads none), seeded prompts (an enc-dec config
also gets 0.1 * N(0, 1) encoder frames, one per prompt token), a prefill
of the prompt, then `gen - 1` greedy decode steps with the caches written
in place. Without `--full` the config is the family's reduced variant.
`--patches N` puts patch embeddings (0.1 * N(0, 1)) on the first N prompt
positions of a vlm config through `embed_mask`; the default 0 sends
tokens only, as the reference's launcher does. Runs on the card unless
`--device cpu`; without a card and without `--device cpu` it raises.

`main(argv)` returns the report: the prefill ms, the decoded tokens and
seconds, tokens per second, each decode step's ms, and for an in-process
caller the config, the LM, the batch, the final decode state, the
generated tokens and every step's logits.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models import (
    count_params, decode_step, get_arch, init_decode_state, init_params, prefill,
)


def make_batch(cfg, batch: int, prompt_len: int, *, patches: int = 0,
               seed: int = 1, device=None) -> dict:
    """Seeded prompts (B, prompt_len) on `device`, with an enc-dec config's
    encoder frames and a vlm's patch embeddings on the first `patches`
    positions."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, size=(batch, prompt_len)), device=dev)}

    def frames():
        return torch.as_tensor(
            0.1 * rng.normal(size=(batch, prompt_len, cfg.d_model)),
            dtype=torch.float32, device=dev)

    if cfg.is_encdec:
        out["enc_embeds"] = frames()
    if patches:
        if cfg.family != "vlm" or patches > prompt_len:
            raise ValueError(f"{cfg.name}: --patches {patches} needs a vlm "
                             f"config and at most {prompt_len} positions")
        out["embeds"] = frames()
        mask = torch.zeros((batch, prompt_len), dtype=torch.bool, device=dev)
        mask[:, :patches] = True
        out["embed_mask"] = mask
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(cfg, lm, batch: dict, gen: int) -> dict:
    """Prefill `batch`, then `gen - 1` greedy decode steps: the state, the
    tokens (B, gen), every step's logits (B, gen, V) fp32, and the times:
    prefill and the decode loop on the host clock, the card synchronized
    before each read, and each decode step's ms between stamps in stream
    order (CUDA events on the card, so the loop never waits on them; the
    host clock on the CPU)."""
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    dev = lm.embed.device
    b, p = batch["tokens"].shape
    enc_len = batch["enc_embeds"].shape[1] if cfg.is_encdec else 0
    state = init_decode_state(cfg, b, p + gen, lm.embed.dtype, enc_len=enc_len,
                              device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    state, logits = prefill(cfg, lm, state, batch)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    tok = torch.argmax(logits, -1)
    tokens, steps, stamps = [tok], [logits], []

    def stamp():
        if dev.type == "cuda":
            stamps.append(torch.cuda.Event(enable_timing=True))
            stamps[-1].record()
        else:
            stamps.append(time.perf_counter())

    t0 = time.perf_counter()
    stamp()
    for _ in range(gen - 1):
        state, logits = decode_step(cfg, lm, state, tok)
        tok = torch.argmax(logits, -1)
        tokens.append(tok)
        steps.append(logits)
        stamp()
    _sync(dev)
    decode_s = time.perf_counter() - t0
    if dev.type == "cuda":
        step_ms = [s0.elapsed_time(s1) for s0, s1 in zip(stamps, stamps[1:])]
    else:
        step_ms = [(s1 - s0) * 1e3 for s0, s1 in zip(stamps, stamps[1:])]
    n_tok = b * (gen - 1)
    return {"state": state, "tokens": torch.stack(tokens, 1),
            "logits": torch.stack(steps, 1), "prefill_ms": prefill_s * 1e3,
            "decode_s": decode_s, "decode_tokens": n_tok, "step_ms": step_ms,
            "tokens_per_s": n_tok / decode_s if decode_s > 0 else float("nan")}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--patches", type=int, default=0,
                    help="vlm: patch embeddings on the first N prompt positions")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' on purpose)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    lm = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                     dtype=torch.float32, device=dev)
    batch = make_batch(cfg, args.batch, args.prompt_len, patches=args.patches,
                       device=dev)
    out = generate(cfg, lm, batch, args.gen)
    n_params = count_params(cfg, lm)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[serve] {cfg.name}: {n_params} parameters, fp32, on {where}")
    print(f"[serve] prefill {args.prompt_len}x{args.batch}: "
          f"{out['prefill_ms']:.1f} ms")
    print(f"[serve] decoded {out['decode_tokens']} tokens in "
          f"{out['decode_s']:.3f} s ({out['tokens_per_s']:.1f} tokens/s)")
    if len(out["step_ms"]) > 1:
        print(f"[serve] decode step ms: first {out['step_ms'][0]:.2f}, median "
              f"of the rest {float(np.median(out['step_ms'][1:])):.2f}")
    return {"arch": cfg.name, "params": n_params, "device": where, "cfg": cfg,
            "lm": lm, "batch": batch, **out}


if __name__ == "__main__":
    main()
