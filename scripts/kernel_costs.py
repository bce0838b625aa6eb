"""Time the port's fused kernels (B1-B4) at their main-path shapes, with the
per-entry cost table and the compiled binaries' summary, on one GPU.

    python3 scripts/kernel_costs.py [--src DIR] [--out FILE] [--only PARTS]
        [--wave-slots S1,S9] [--profile]

`--src` is the `src/` directory whose `repro_torch` is measured (default:
this checkout's); its kernels are built from its own `kernels/csrc/` into
its own `build/kernels/`. So two trees are compared on one card in one call
by running this script once per tree, in turns (A, B, B, A). The
measurements are `chip_smoke.py`'s own functions:

- `binary`: the build's ptxas registers, stack and spill and the SASS counts
  (LDL, STL, MUFU, BAR, HMMA, LDS, STS; the entry loop and the chunk loop)
  of the fp32 instances at t-chunks 1 and 16 (`binary_summary`);
- `costs`: the per-entry cost table: B1 at (2^16, 2^16) for d in {2, 9} and
  the specs rbf, matern32, matern32 * wendland2, then B1, B2 and B3 at
  d 9, matern32, t 1 and 9 (`entry_cost_table`);
- `dense`, `ring`, `b4`: B1 and B2 at (2^16, 2^16, 9, 1) and (2^17, 2^17,
  9, 1), B1 at a 1024-row prediction chunk (t = 128) and at a served
  batch of 64 queries (t = 1 and 128), B3 at a ring step
  (2^17 x 2^17, t = 1 and 9) and B4 at the spatial path's shape (n = 2^18,
  tile 256, t = 1 and 9), each against its plain version (2e-4 of
  max|out|) and beside its two bounds;
- `waves` (with `--wave-slots`): B2 and B3 at t 1 and 9 over m = n rows and
  over the m <= n rows that fill whole waves of the card (m a multiple of
  64 x the resident blocks of the card, S1 at t = 1 and S9 at t = 9),
  against n = 2^16 and 2^17 columns: the ps per entry of each, so the
  difference is the cost of the last, partial wave.

`--profile` runs `torch.profiler` over two B3 ring steps at t = 9 and
prints its table of device time per kernel. Prints one JSON object as its
last line and writes it to `--out` when given. Exits non-zero without a
card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


PARTS = ("binary", "costs", "dense", "ring", "b4", "waves")


def wave_rows(cs, slots: dict) -> list:
    """ps per entry of B2 and B3 at m = n rows and at the m that fills whole
    waves (a multiple of 64 slots[t]), n in {2^16, 2^17}."""
    from repro_torch.kernels import kmvm

    components, scal = cs.COST_SPECS["matern32"]
    scalars = torch.tensor(scal, dtype=torch.float32, device=cs.DEV)
    rows = []
    for n in (1 << 16, 1 << 17):
        g = torch.Generator(device=cs.DEV).manual_seed(19)
        X = torch.randn((n, 9), generator=g, device=cs.DEV) / math.sqrt(9)
        for t in (1, 9):
            V = torch.randn((n, t), generator=g, device=cs.DEV)
            fill = n // (64 * slots[t]) * 64 * slots[t]
            for name in ("kmvm_dots", "kmvm_chunk"):
                row = {"kernel": name, "n": n, "t": t, "slots": slots[t]}
                for key, m in (("full", n), ("fill", fill)):
                    ms = cs._time_ms(cs.kernel_call(kmvm, name, components, X,
                                                    V, scalars, rows=m), 3)
                    row[key] = {"m": m, "ms": ms, "ps_per_entry": ms * 1e9 / (m * n)}
                row["tail_share"] = 1.0 - (row["fill"]["ps_per_entry"]
                                           / row["full"]["ps_per_entry"])
                cs.log(f"[waves] {cs.KERNEL_LABEL[name]} n {n} t {t}: m {n} "
                       f"{row['full']['ps_per_entry']:.3f} ps, m {fill} "
                       f"({fill // 64} blocks, {slots[t]} slots) "
                       f"{row['fill']['ps_per_entry']:.3f} ps per entry: tail "
                       f"{row['tail_share']:.1%}")
                rows.append(row)
    return rows


def profile_ring_step(cs) -> dict:
    """torch.profiler over two B3 ring steps at t = 9: the device time per
    kernel name, or none if the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import kmvm

    n = cs.RING_STEP
    g = torch.Generator(device=cs.DEV).manual_seed(13)
    X = torch.randn((n, 9), generator=g, device=cs.DEV) / math.sqrt(9)
    V = torch.randn((n, 9), generator=g, device=cs.DEV)
    components, scal = cs.COST_SPECS["matern32"]
    scalars = torch.tensor(scal, dtype=torch.float32, device=cs.DEV)
    step = cs.kernel_call(kmvm, "kmvm_chunk", components, X, V, scalars)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = {}
    for e in events:
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us:
            device[e.key] = us / 1e3
    cs.log(f"[profile] B3 ring step x 2, device ms per kernel: {device or 'none'}")
    return {"device_ms": device}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", default=",".join(PARTS[:-1]),
                    help=f"comma-separated parts of {PARTS}")
    ap.add_argument("--wave-slots", default=None,
                    help="resident blocks on the card at t = 1 and t = 9")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    parts = set(args.only.split(","))
    if not parts <= set(PARTS):
        raise SystemExit(f"kernel_costs: unknown parts {parts - set(PARTS)}")
    if "waves" in parts and not args.wave_slots:
        raise SystemExit("kernel_costs: the waves part needs --wave-slots")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_costs: no CUDA device available")
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import chip_smoke as cs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cs.log(f"[costs] {card}; src {args.src}; parts {sorted(parts)}")
    result = {"card": card, "src": args.src}
    binary = cs.phase_build()
    if "binary" in parts:
        result["binary"] = binary
    if "costs" in parts:
        result["costs"] = cs.entry_cost_table()
    if "waves" in parts:
        s1, s9 = (int(v) for v in args.wave_slots.split(","))
        result["waves"] = wave_rows(cs, {1: s1, 9: s9})
    if "dense" in parts:
        components = (("matern32",),)
        scalars = torch.tensor([1.0, 1.0], dtype=torch.float32, device="cuda")
        dense = []
        for n in (1 << 16, 1 << 17):
            g = torch.Generator(device="cuda").manual_seed(7)
            X = torch.randn((n, 9), generator=g, device="cuda") / math.sqrt(9)
            v = torch.randn((n, 1), generator=g, device="cuda")
            r = torch.randn((n, 1), generator=g, device="cuda")
            for name, rows in cs.time_square(components, scalars, X, v, r).items():
                dense += [{"name": name, **row} for row in rows]
            if n == 1 << 16:
                # B1 at a prediction chunk, as the smoke times it, and at a
                # served batch of 64 queries (mean t = 1, variance t = 128)
                from repro_torch.kernels import kmvm

                v128 = torch.randn((n, 128), generator=g, device="cuda")
                for rows, rhs in ((1024, v128), (64, v), (64, v128)):
                    q = X[:rows].contiguous()
                    dense.append({"name": "kmvm", **cs._time_row(
                        "kmvm", (rows, n, 9, rhs.shape[1]), components,
                        lambda: kmvm.kmvm_fused(components, q, X, rhs, scalars),
                        lambda: kmvm.kmvm_plain(components, q, X, rhs, scalars),
                        10, 5)})
            del X, v, r
        result["dense"] = dense
    if "ring" in parts:
        result["ring_step"], _ = cs.time_ring_step()
    if "b4" in parts:
        Xf, _, _ = cs.make_spatial_field(cs.SPATIAL_N, seed=cs.DATA_SEED)
        result["b4"], _ = cs.time_b4_spatial(Xf)
    if args.profile:
        result["profile"] = profile_ring_step(cs)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return result


if __name__ == "__main__":
    main()
