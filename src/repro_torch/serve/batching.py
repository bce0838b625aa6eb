"""Closed micro-batching for the serve path.

Serving traffic is dominated by small concurrent requests; launching the
engine per request would pay one cross-MVM sweep per caller. `MicroBatcher`
has one worker thread accumulate queued requests until `max_batch` rows are
waiting or `max_wait_ms` has passed, zero-pad the block to a bucket size,
run ONE `engine.predict`, and scatter per-request slices back through
Futures. Exceptions in a batch reach every caller in it.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import NamedTuple

import numpy as np


class BatcherConfig(NamedTuple):
    """max_batch: rows that close a batch immediately once reached.
    max_wait_ms: accumulation deadline after the first queued request.
    bucket_sizes: padded launch sizes (rows); a block larger than the
    biggest bucket is padded to a multiple of it instead."""

    max_batch: int = 256
    max_wait_ms: float = 2.0
    bucket_sizes: tuple = (16, 64, 256)


class _Request(NamedTuple):
    X: np.ndarray
    future: Future


_SENTINEL = None  # queue poison pill


class MicroBatcher:
    """Batches concurrent `predict` calls onto one PredictionEngine."""

    def __init__(self, engine, config: BatcherConfig = BatcherConfig()):
        self.engine = engine
        self.config = config
        self._buckets = tuple(sorted(set(int(b) for b in config.bucket_sizes)))
        if not self._buckets:
            raise ValueError("bucket_sizes must be non-empty")
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self.batches_run = 0
        self.requests_served = 0
        self.rows_served = 0
        self.rows_padded = 0
        self._thread = threading.Thread(
            target=self._worker, name="micro-batcher", daemon=True)
        self._thread.start()

    def submit(self, Xstar) -> Future:
        """Enqueue an (m, d) query; resolves to (mean, var) numpy arrays."""
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        X = np.asarray(Xstar)
        if X.ndim == 1:
            X = X[None, :]
        f: Future = Future()
        self._q.put(_Request(X, f))
        return f

    def predict(self, Xstar, timeout: float | None = None):
        """Blocking convenience around submit()."""
        return self.submit(Xstar).result(timeout=timeout)

    def close(self) -> None:
        """Drain the queue, stop the worker, fail what was never served."""
        if not self._closed:
            self._closed = True
            self._q.put(_SENTINEL)
            self._thread.join()
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _SENTINEL and not item.future.done():
                item.future.set_exception(
                    RuntimeError("MicroBatcher closed before serving"))

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                return
            batch = [item]
            rows = item.X.shape[0]
            deadline = time.monotonic() + self.config.max_wait_ms / 1e3
            stop = False
            while rows < self.config.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _SENTINEL:
                    stop = True
                    break
                batch.append(nxt)
                rows += nxt.X.shape[0]
            self._run_batch(batch)
            if stop:
                return

    def _bucket_rows(self, rows: int) -> int:
        for b in self._buckets:
            if rows <= b:
                return b
        big = self._buckets[-1]
        return -(-rows // big) * big

    def _run_batch(self, batch: list) -> None:
        try:
            X = np.concatenate([r.X for r in batch], axis=0)
            rows = X.shape[0]
            padded = self._bucket_rows(rows)
            Xp = np.zeros((padded,) + X.shape[1:], X.dtype)
            Xp[:rows] = X
            mean, var = self.engine.predict(Xp)
            mean, var = mean.cpu().numpy(), var.cpu().numpy()
            offset = 0
            for r in batch:
                m = r.X.shape[0]
                r.future.set_result((mean[offset:offset + m],
                                     var[offset:offset + m]))
                offset += m
            self.batches_run += 1
            self.requests_served += len(batch)
            self.rows_served += rows
            self.rows_padded += padded - rows
        except Exception as e:  # reaches every caller in the batch
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
