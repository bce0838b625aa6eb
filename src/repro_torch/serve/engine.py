"""PredictionEngine — chunked GP prediction from a PosteriorArtifact.

Restores an artifact onto any registered KernelOperator backend on one
device and serves `predict(Xstar)` with a FIXED chunk size over the test
set: every launch sees the same (chunk_size, d) shape
(`partitioned.map_row_chunks` pads the tail chunk), and one chunk's
(chunk, r) cross-products are live at a time, so large test batches stream
against large training sets. `compute_dtype="bfloat16"` re-binds the
operator with bf16 cross-MVMs; cache state stays fp32. On a compactly
supported blocksparse operator each request batch is Morton-sorted before
chunking (`sort_queries`), so chunks are spatially local and the
operator's runtime tile pruning bites; results return in request order.
"""

from __future__ import annotations

import threading
import time

import torch

from repro_torch import obs
from repro_torch.core.operators import make_operator
from repro_torch.core.partitioned import map_row_chunks
from repro_torch.core.predcache import predict_mean, predict_var_cached
from repro_torch.sparse.plan import morton_order

from .artifact import PosteriorArtifact, load_artifact

_KEEP = "__keep__"  # sentinel: inherit the artifact's compute_dtype


class PredictionEngine:
    """Serves mean + variance predictions from a restored artifact.

    backend: registry key override (None = the artifact's). compute_dtype:
    override of the operator's matmul dtype (default: the artifact's).
    chunk_size: rows per launch. include_noise: add sigma^2 to variances.
    device: where the engine computes (None = the card; raises when there
    is none). sort_queries: Morton-sort each batch before chunking (None =
    on for a compactly supported blocksparse plan, off otherwise).
    """

    def __init__(self, artifact: PosteriorArtifact, *,
                 backend: str | None = None,
                 compute_dtype: str | None = _KEEP,
                 chunk_size: int = 1024,
                 include_noise: bool = True,
                 sort_queries: bool | None = None,
                 device=None):
        config = artifact.config
        if backend is not None:
            config = config._replace(backend=backend)
        if compute_dtype is not _KEEP:
            config = config._replace(compute_dtype=compute_dtype)
        self.config = config
        self.chunk_size = int(chunk_size)
        self.include_noise = include_noise
        self.op = make_operator(config, artifact.X, artifact.params, device=device)
        dev = self.op.device
        self.artifact = artifact._replace(
            X=self.op.X, params=self.op.params,
            mean_cache=artifact.mean_cache.to(dev),
            var_Q=artifact.var_Q.to(dev),
            var_T_chol=artifact.var_T_chol.to(dev),
            solve_rel_residual=artifact.solve_rel_residual.to(dev))
        self._cache = self.artifact.cache()
        if sort_queries is None:
            plan = getattr(self.op, "plan", None)
            sort_queries = plan is not None and plan.compact
        self.sort_queries = bool(sort_queries)
        # counters; several batcher threads may drive one engine
        self.chunks_run = 0
        self.rows_served = 0
        self._counter_lock = threading.Lock()

    @classmethod
    def from_dir(cls, directory: str, **kwargs) -> "PredictionEngine":
        """An engine on the artifact saved under `directory`, restored onto
        the engine's own device (`device=` in kwargs; None = the card)."""
        return cls(load_artifact(directory, device=kwargs.get("device")), **kwargs)

    @property
    def backend(self) -> str:
        return self.config.backend

    def _predict_chunk(self, Xc: torch.Tensor):
        mean = predict_mean(self.op, Xc, self._cache)
        var = predict_var_cached(self.op, Xc, self._cache,
                                 include_noise=self.include_noise)
        return mean, var

    def warmup(self) -> None:
        """One chunk before traffic arrives (builds the kernels on the card)."""
        d = self.op.X.shape[1]
        self._predict_chunk(torch.zeros((self.chunk_size, d), dtype=self.op.dtype,
                                        device=self.op.device))
        if self.op.device.type == "cuda":
            torch.cuda.synchronize(self.op.device)

    def predict(self, Xstar) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, var) for (m, d) query points; any m, one chunk shape.
        Under tracing a `serve_predict` span covers the call (synchronized
        on the card), with the Morton sort's read of the queries
        (`serve_sort_read`) and the sort itself (`serve_morton_sort`,
        host-only) inside it; the `serve.predict_ms` / `serve.predict_rows`
        histograms record every call."""
        t0 = time.perf_counter()
        with obs.span("serve_predict"):
            Xstar = torch.as_tensor(Xstar, device=self.op.device).to(self.op.dtype)
            if Xstar.ndim == 1:
                Xstar = Xstar[None, :]
            m = Xstar.shape[0]
            inv = None
            if self.sort_queries and m > 1:
                # the order comes from the host (a few query rows); the
                # inverse permutation is a scatter on the device
                with obs.read_span("serve_sort_read"):
                    Xh = Xstar.cpu().numpy()
                with obs.host_span("serve_morton_sort"):
                    order = morton_order(Xh)
                order = torch.as_tensor(order, device=Xstar.device).long()
                inv = torch.empty_like(order)
                inv[order] = torch.arange(m, device=Xstar.device)
                Xstar = Xstar[order]
            out = map_row_chunks(self._predict_chunk, Xstar, self.chunk_size)
            if inv is not None:
                out = tuple(a[inv] for a in out)
            if obs.tracing_enabled() and self.op.device.type == "cuda":
                torch.cuda.synchronize(self.op.device)
        with self._counter_lock:
            self.chunks_run += -(-max(m, 1) // self.chunk_size)
            self.rows_served += m
        obs.histogram("serve.predict_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        obs.histogram("serve.predict_rows").observe(m)
        return out

    def predict_mean(self, Xstar) -> torch.Tensor:
        """The posterior mean alone: `predict(Xstar)[0]`."""
        return self.predict(Xstar)[0]
