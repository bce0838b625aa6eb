"""Synthetic token pipeline for the LM architectures.

The counterpart of `repro.data.tokens`. No corpora: training exercises the
system with a synthetic token stream (zipf-distributed ids with bigram
rules, structured enough that the loss falls). `_synth_stream` is the
reference's numpy generator, so the same seed gives the same arrays bit for
bit. `TokenPipeline` fills a bounded queue from a worker thread: the worker
puts each batch in pinned host memory, and the consumer copies it to the
card with `non_blocking=True` on the caller's current stream, so the copy
overlaps the previous step. Tokens are int32 as in the reference; the
model casts where an index op needs int64.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class TokenBatch(NamedTuple):
    tokens: torch.Tensor   # (batch, seq) int32
    targets: torch.Tensor  # (batch, seq) int32 (next-token)


def token_batch_specs(batch: int, seq: int, device="meta") -> dict:
    """Shapes and dtypes of a batch, as empty tensors on `device`."""
    return {
        "tokens": torch.empty((batch, seq), dtype=torch.int32, device=device),
        "targets": torch.empty((batch, seq), dtype=torch.int32, device=device),
    }


def _synth_stream(vocab: int, batch: int, seq: int, seed: int) -> Iterator[dict]:
    """Markov-ish zipf stream: learnable structure, unbounded length."""
    rng = np.random.default_rng(seed)
    # sparse bigram transition "rules" the model can learn
    nrules = min(vocab, 4096)
    rule_next = rng.integers(0, vocab, size=nrules)
    while True:
        base = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64)
        toks = np.minimum(base, vocab - 1).astype(np.int32)
        # apply bigram rules with prob .5 where the prev token has a rule
        prev = toks[:, :-1]
        mask = (prev < nrules) & (rng.random(prev.shape) < 0.5)
        nxt = toks[:, 1:].copy()
        nxt[mask] = rule_next[prev[mask]].astype(np.int32)
        toks[:, 1:] = nxt
        yield {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class TokenPipeline:
    """Prefetch of synthetic batches onto a device (default: the card).

    `batch` is the global batch. With `mesh=None` a batch is one plain
    tensor pair on `device`. With a `launch.mesh.Mesh` every rank draws the
    same global batch from `seed`, keeps its rows of the data axes
    (`data_axes` present in the mesh; rank coordinate c of D takes rows
    [c * B / D, (c + 1) * B / D)) and hands out a DTensor sharded over
    those axes on dim 0 and replicated over the rest, on the mesh's device:
    the reference's global batch placed by a `NamedSharding` over the data
    axes. A global batch the data axes do not divide raises.
    """

    def __init__(self, mesh, vocab: int, batch: int, seq: int, *,
                 seed: int = 0, data_axes=("data",), prefetch: int = 2,
                 device=None):
        self.mesh = mesh
        self.device = (mesh.device if mesh is not None and device is None
                       else resolve_device(device))
        self._rows = slice(None)
        self._placements = None
        if mesh is not None:
            axes = tuple(a for a in data_axes if a in mesh.axis_names)
            ranks, coord = 1, 0
            for a in axes:
                ranks, coord = ranks * mesh.axis_size(a), \
                    coord * mesh.axis_size(a) + mesh.axis_index(a)
            if batch % ranks:
                raise ValueError(f"the global batch {batch} does not divide "
                                 f"over the data axes {axes} of size {ranks}")
            n = batch // ranks
            self._rows = slice(coord * n, (coord + 1) * n)
            from repro_torch.models.sharding import placements

            self._placements = placements(mesh, (axes or None,), 2)
        self._pin = self.device.type == "cuda"
        self._it = _synth_stream(vocab, batch, seq, seed)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        for item in self._it:
            if self._stop.is_set():
                return
            host = {k: torch.from_numpy(np.ascontiguousarray(v[self._rows]))
                    for k, v in item.items()}
            if self._pin:
                host = {k: v.pin_memory() for k, v in host.items()}
            while not self._stop.is_set():
                try:
                    self._q.put(host, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __next__(self) -> TokenBatch:
        d = self._q.get()
        d = {k: v.to(self.device, non_blocking=True) for k, v in d.items()}
        if self._placements is not None:
            from torch.distributed.tensor import DTensor

            dm = self.mesh.device_mesh
            d = {k: DTensor.from_local(v, dm, self._placements, run_check=False)
                 for k, v in d.items()}
        return TokenBatch(tokens=d["tokens"], targets=d["targets"])

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
