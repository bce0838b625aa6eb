"""End-to-end LM training driver on the port: a small config, a few dozen
steps, the fault-tolerant loop (checkpoint / auto-resume / NaN-skip),
synthetic tokens. The counterpart of `examples/train_lm.py`.

Default is a CPU-sized config; pass --arch / --steps to scale and --full
for the published config (on the card). This is the train step the port's
dry run counts at full scale. As the reference's example, it builds its
mesh with `make_host_mesh(model=1)`: under `torchrun` it trains
data-parallel over every rank (the state placed as DTensors, each rank
feeding its rows of the global `--batch`); a lone process trains on plain
tensors.

    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 30
    PYTHONPATH=src python examples/train_lm_torch.py --arch mamba2-130m --full
    torchrun --nproc_per_node=4 examples/train_lm_torch.py --full
"""

import argparse

import torch
import torch.distributed as dist

from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch.mesh import make_host_mesh, mesh_axis_sizes
from repro_torch.launch.steps import (
    init_train_state, make_train_step, place_train_state,
)
from repro_torch.models import count_params, get_arch
from repro_torch.train.trainer import TrainLoopConfig, run_train_loop


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="use the published config (on the card)")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' on purpose)")
    args = ap.parse_args(argv)

    created = not dist.is_initialized()
    mesh = make_host_mesh(model=1, device=args.device)
    dev = mesh.device
    sharded = dist.get_world_size() > 1
    lead = mesh.rank == 0
    cfg = get_arch(args.arch)
    if not args.full:
        # a ~10M-parameter reduction that still learns on the CPU
        cfg = cfg.reduced(n_layers=4, d_model=256, d_ff=704, vocab=4096,
                          n_heads=8, head_dim=32, n_kv_heads=4,
                          ce_chunk=args.seq, attn_chunk=args.seq)
        if cfg.ssm_state:
            cfg = cfg._replace(ssm_state=32, ssm_head_dim=32, ssm_chunk=32)
    if lead:
        print(f"arch={cfg.name} params={count_params(cfg):,} device={dev} "
              f"mesh={mesh_axis_sizes(mesh)}")

    step = make_train_step(cfg, mesh, lr=1e-3)
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    place = (lambda st: place_train_state(mesh, st)) if sharded else None
    if sharded:
        state = place(state)
    pipe = TokenPipeline(mesh if sharded else None, cfg.vocab, args.batch,
                         args.seq, seed=0, device=dev)
    batches = ({"tokens": b.tokens, "targets": b.targets} for b in pipe)
    loop_cfg = TrainLoopConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt or None, ckpt_every=50,
        log_every=10, tokens_per_step=args.batch * args.seq)
    try:
        res = run_train_loop(step, state, batches, loop_cfg, place=place)
    finally:
        pipe.close()
        if created:
            dist.destroy_process_group()

    first = float(res.metrics_history[0]["loss"])
    last = float(res.metrics_history[-1]["loss"])
    if lead:
        print(f"loss {first:.3f} -> {last:.3f} over {res.steps_run} steps "
              f"({res.skipped} skipped)")
    if last >= first:
        raise SystemExit("the model did not learn")
    return {"first": first, "last": last, "steps": res.steps_run}


if __name__ == "__main__":
    main()
