"""Every point where one served request makes the host wait for the card.

    python3 scripts/serve_sync_audit.py [--n 65536] [--rows 4096] \
        [--out build/serve_sync_audit.json]

Needs the card. Fits a posterior on the block-sparse backend (the taper
configuration's `matern32 * wendland2`, radius 0.15, on clustered 2-D
points) and on the dense one (`matern32` on `pallas`, d 9), puts each
engine behind a MicroBatcher with the benchmark's settings (max_batch 128,
2 ms, buckets 16/64/128, chunk 1024), sends one request to build every
kernel, then one traced request under
`torch.cuda.set_sync_debug_mode("warn")`. Every synchronizing call that
PyTorch reports on the request path is listed by its place in
`repro_torch` and by the spans open around it on the batcher's thread: a
read from the card sits in a read span of its own (`obs.read_span`).
Prints one JSON line a backend and writes them all to `--out`.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.core.kernels_math import init_kernel_params, init_params  # noqa: E402
from repro_torch.core.operators import OperatorConfig, make_operator  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.serve import (BatcherConfig, MicroBatcher, PredictionEngine,  # noqa: E402
                               fit_posterior)

PKG = os.path.join(ROOT, "src", "repro_torch")
DEV = "cuda"


def _problem(backend: str, n: int, rng):
    if backend == "blocksparse":
        centers = rng.uniform(size=(32, 2))
        X = (centers[rng.integers(0, 32, n)] + 0.03 * rng.standard_normal((n, 2)))
        y = np.sin(6 * X[:, 0]) * np.cos(4 * X[:, 1])
        kernel = "matern32 * wendland2"
        params = init_kernel_params(kernel, lengthscale=0.693, radius=0.15, noise=0.3,
                                    device=DEV)
    else:
        X = rng.standard_normal((n, 9))
        y = np.sin(X @ rng.standard_normal(9))
        kernel = "matern32"
        params = init_params(lengthscale=2.5, outputscale=0.6, noise=0.06, device=DEV)
    X = X.astype(np.float32)
    y = (y + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return kernel, params, X, y


def audit(backend: str, n: int, rows: int, seed: int = 0) -> dict:
    """The synchronizing calls of one `rows`-row request, by place and span."""
    rng = np.random.default_rng(seed)
    kernel, params, X, y = _problem(backend, n, rng)
    op = make_operator(OperatorConfig(kernel=kernel, backend=backend), X, params,
                       device=DEV)
    art = fit_posterior(op, y, v0=torch.ones(n, device=DEV), precond_rank=50,
                        lanczos_rank=100)
    engine = PredictionEngine(art, chunk_size=1024, device=DEV)
    query = X[rng.integers(0, n, rows)] + 0.01 * rng.standard_normal((rows, X.shape[1]))
    query = query.astype(np.float32)
    found: collections.Counter = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = [fr for fr in traceback.extract_stack()[:-1]
                 if not fr.filename.endswith("warnings.py")]
        inner = [fr for fr in stack if fr.filename.startswith(PKG)] or stack[-1:]
        fr = inner[-1]
        place = f"{os.path.relpath(fr.filename, ROOT)}:{fr.lineno}: {fr.line}"
        spans = [s.name for s in trace._open_spans()]
        kinds = [s.kind for s in trace._open_spans()]
        found[(place, "/".join(spans), "read" in kinds)] += 1

    config = BatcherConfig(max_batch=128, max_wait_ms=2.0, bucket_sizes=(16, 64, 128))
    with MicroBatcher(engine, config) as mb:
        mb.submit(query).result(timeout=300)
        torch.cuda.synchronize()
        shown = warnings.showwarning
        warnings.simplefilter("always")
        warnings.showwarning = record
        obs.enable_tracing(None)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            mb.submit(query).result(timeout=300)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            obs.disable_tracing(snapshot_metrics=False)
            warnings.showwarning = shown
        obs.drain_events()
    reads = {k[len("span."):]: v["count"] for k, v in obs.registry().snapshot().items()
             if k.startswith("span.") and v["count"] and v["kind"] == "read"}
    syncs = [{"place": p, "spans": s, "in_read_span": r, "count": c}
             for (p, s, r), c in sorted(found.items(), key=lambda kv: kv[0][0])]
    return {"backend": backend, "n": n, "rows": rows, "syncs": syncs,
            "syncs_total": sum(found.values()),
            "syncs_outside_read_spans": sum(c for (_, _, r), c in found.items() if not r),
            "read_spans": reads, "reads_total": sum(reads.values()),
            "device": torch.cuda.get_device_name(0)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=65536)
    p.add_argument("--rows", type=int, default=4096)
    p.add_argument("--out", default=os.path.join("build", "serve_sync_audit.json"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    out = [audit(b, args.n, args.rows) for b in ("blocksparse", "pallas")]
    for rec in out:
        print(json.dumps(rec))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
