"""Where a decode step's time goes: one LM at its published width, fp32, on
one GPU, under `torch.profiler`.

    python3 scripts/serve_lm_profile.py [--arch smollm-360m] [--batch 4]
        [--prompt-len 256] [--steps 8]

Builds the arch at full width from a seeded generator, prefills a seeded
prompt and takes 3 warm-up decode steps (`repro_torch.launch.serve`), then
profiles `--steps` further decode steps. Prints, per step: the wall time
(host clock, the card synchronized before each read), the card's busy time
(the sum of the CUDA kernels' self time), their ratio, the kernel launches,
and the host's time inside the PyTorch operators; then the operators with
the most host time and the kernels with the most device time. Prints one
JSON object as its last line. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serve_lm_profile: no CUDA device available")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import make_batch
    from repro_torch.models import (
        decode_step, get_arch, init_decode_state, init_params, prefill)

    cfg = get_arch(args.arch)
    lm = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                     dtype=torch.float32, device="cuda")
    batch = make_batch(cfg, args.batch, args.prompt_len, device="cuda")
    enc_len = args.prompt_len if cfg.is_encdec else 0
    state = init_decode_state(cfg, args.batch, args.prompt_len + 3 + args.steps,
                              torch.float32, enc_len=enc_len, device="cuda")
    state, logits = prefill(cfg, lm, state, batch)
    tok = torch.argmax(logits, -1)
    for _ in range(3):   # warm-up
        state, logits = decode_step(cfg, lm, state, tok)
        tok = torch.argmax(logits, -1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, logits = decode_step(cfg, lm, state, tok)
            tok = torch.argmax(logits, -1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    ops = sorted((e for e in events if e.device_type.name == "CPU"
                  and e.key.startswith("aten::")),
                 key=lambda e: -e.self_cpu_time_total)
    host_us = sum(e.self_cpu_time_total for e in ops)
    card = torch.cuda.get_device_name(0)
    n = args.steps
    row = {"arch": cfg.name, "batch": args.batch, "prompt": args.prompt_len,
           "steps": n, "step_ms": wall * 1e3 / n,
           "device_busy_ms": busy_us / 1e3 / n,
           "busy_share": busy_us / 1e6 / wall, "kernels_per_step": launches / n,
           "aten_host_ms": host_us / 1e3 / n, "card": card}
    print(f"[profile] {cfg.name} decode, batch {args.batch}, after a "
          f"{args.prompt_len}-token prompt, {n} steps on {card}: "
          f"{row['step_ms']:.2f} ms a step, the card busy "
          f"{row['device_busy_ms']:.2f} ms of it ({100 * row['busy_share']:.1f}%), "
          f"{row['kernels_per_step']:.0f} kernels a step, "
          f"{row['aten_host_ms']:.2f} ms of host time in aten operators")
    print("[profile] operators by host time (self, per step):")
    for e in ops[:12]:
        print(f"  {e.key:<40} {e.self_cpu_time_total / 1e3 / n:8.3f} ms "
              f"{e.count / n:6.0f} calls")
    print("[profile] kernels by device time (per step):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.key[:60]:<60} {e.self_device_time_total / 1e3 / n:8.3f} ms "
              f"{e.count / n:6.0f} launches")
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
