"""Request batching for the serve path: closed micro-batches and a
continuous, pipelined scheduler.

The counterpart of `repro.serve.batching`. Serving traffic is dominated by
small concurrent requests; launching the engine per request would pay one
cross-MVM sweep per caller. Two schedulers amortize that:

`MicroBatcher` — the closed batcher: one worker thread accumulates queued
requests until `max_batch` rows are waiting or `max_wait_ms` has passed,
zero-pads the block to a bucket size, runs ONE `engine.predict`, and
scatters per-request slices back through Futures.

`ContinuousBatcher` — the pipelined scheduler: an assembler thread ships a
block the moment a launch slot frees and any requests are pending, and
keeps assembling the next block while the current one runs on the worker
threads. It is multi-model: per-model queues with deficit-fair scheduling,
and each block goes to one of its model's engine replicas.
`repro_torch.serve.fleet.ServeFleet` drives it.

Engines return tensors on their device; a worker copies a block's mean and
variance to the host once, before it scatters the futures. Exceptions in a
block reach every caller in it. With tracing on, every request is traced
under its request ID (`serve_request` with `serve_queue` / `serve_solve`
children on a synthetic `req:<rid>` tid), the host's work on a block is
spanned (`serve_batch_wait`: the closed batcher's worker waiting for a
batch; `serve_assemble`, `serve_scatter`: host-only; `serve_to_host`: one
span a read from the card), and the schedulers export `serve.*` gauges and
histograms (`repro_torch.obs`). Times are on the trace's clock
(`obs.clock_us`).
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from typing import NamedTuple

import numpy as np

from repro_torch import obs


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
    t_enq: float = 0.0  # enqueue time, obs.clock_us() (serve.request_wait_ms)
    rid: str = ""       # request ID ("" when tracing is off at submit)


_SENTINEL = None  # queue poison pill


def _to_host(mean, var) -> tuple[np.ndarray, np.ndarray]:
    """A block's results on the host: one copy each, before the scatter."""
    with obs.read_span("serve_to_host"):
        mean = mean.cpu().numpy()
    with obs.read_span("serve_to_host"):
        var = var.cpu().numpy()
    return mean, var


def _emit_request_spans(requests, model: str, t_build: float,
                        t_solve0: float, t_solve1: float) -> None:
    """Per-request spans, emitted once the block completes: on a synthetic
    `req:<rid>` tid, a `serve_request` parent (enqueue -> reply) holding
    `serve_queue` (enqueue -> block build) and `serve_solve` (the engine
    launch), all in microseconds on the trace's clock. The caller checks
    `obs.tracing_enabled()`."""
    t_end = obs.clock_us()
    for r in requests:
        if not r.rid:
            continue
        tid = f"req:{r.rid}"
        obs.complete_event("serve_request", r.t_enq, t_end - r.t_enq,
                           tid=tid, rid=r.rid, model=model,
                           rows=int(r.X.shape[0]))
        obs.complete_event("serve_queue", r.t_enq, t_build - r.t_enq,
                           tid=tid, rid=r.rid)
        obs.complete_event("serve_solve", t_solve0, t_solve1 - t_solve0,
                           tid=tid, rid=r.rid)


def _bucket_rows(buckets: tuple, rows: int) -> int:
    """The padded launch size of a `rows`-row block."""
    for b in buckets:
        if rows <= b:
            return b
    big = buckets[-1]
    return -(-rows // big) * big


def _padded_block(batch: list, buckets: tuple, now: float):
    """(X zero-padded to its bucket, real rows) of a batch of requests,
    with the batch-close histograms recorded (`now`: obs.clock_us())."""
    with obs.host_span("serve_assemble"):
        obs.histogram("serve.batch_requests").observe(len(batch))
        wait_h = obs.histogram("serve.request_wait_ms")
        for r in batch:
            wait_h.observe((now - r.t_enq) / 1e3)
        X = np.concatenate([r.X for r in batch], axis=0)
        rows = X.shape[0]
        padded = _bucket_rows(buckets, rows)
        obs.histogram("serve.batch_rows").observe(rows)
        obs.histogram("serve.batch_pad_rows").observe(padded - rows)
        Xp = np.zeros((padded,) + X.shape[1:], X.dtype)
        Xp[:rows] = X
        return Xp, rows


def _scatter(requests, mean: np.ndarray, var: np.ndarray) -> None:
    with obs.host_span("serve_scatter"):
        offset = 0
        for r in requests:
            m = r.X.shape[0]
            r.future.set_result((mean[offset:offset + m],
                                 var[offset:offset + m]))
            offset += m


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

    def submit(self, Xstar, rid: str | None = None) -> Future:
        """Enqueue an (m, d) query; resolves to (mean, var) numpy arrays.
        `rid` tags the request in the trace; minted here when tracing."""
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        X = np.asarray(Xstar)
        if X.ndim == 1:
            X = X[None, :]
        if rid is None and obs.tracing_enabled():
            rid = obs.next_request_id()
        f: Future = Future()
        self._q.put(_Request(X, f, obs.clock_us(), rid or ""))
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
            with obs.host_span("serve_batch_wait"):
                batch, stop = self._next_batch()
            if batch:
                self._run_batch(batch)
            if stop:
                return

    def _next_batch(self) -> tuple[list, bool]:
        """(the next batch, whether the queue was closed): the first queued
        request, then whatever arrives until `max_batch` rows are waiting or
        `max_wait_ms` has passed."""
        item = self._q.get()
        if item is _SENTINEL:
            return [], True
        batch = [item]
        rows = item.X.shape[0]
        deadline = time.monotonic() + self.config.max_wait_ms / 1e3
        while rows < self.config.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is _SENTINEL:
                return batch, True
            batch.append(nxt)
            rows += nxt.X.shape[0]
        return batch, False

    def _run_batch(self, batch: list) -> None:
        try:
            now = obs.clock_us()
            Xp, rows = _padded_block(batch, self._buckets, now)
            padded = Xp.shape[0]
            t0 = obs.clock_us()
            with obs.span("serve_batch", requests=len(batch), rows=rows,
                          padded=padded):
                mean, var = _to_host(*self.engine.predict(Xp))
            t1 = obs.clock_us()
            _scatter(batch, mean, var)
            if obs.tracing_enabled():
                _emit_request_spans(batch, "micro", now, t0, t1)
            self.batches_run += 1
            self.requests_served += len(batch)
            self.rows_served += rows
            self.rows_padded += padded - rows
        except Exception as e:  # reaches every caller in the batch
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)


# ---------------------------------------------------------------------------
# continuous scheduler
# ---------------------------------------------------------------------------


class SchedulerConfig(NamedTuple):
    """max_batch: row cap per assembled block (a larger single request
    still ships whole: requests are never split).
    bucket_sizes: padded launch sizes, as in BatcherConfig.
    max_inflight: cap on blocks queued or executing at once. Above
    num_workers it allows build-ahead: a block is committed while every
    worker is busy, but only once a full max_batch of rows is pending.
    num_workers: launcher threads; with several engine replicas per model,
    worker i drives replica i % len(replicas).
    quantum_rows: deficit-fair accrual per scheduling round."""

    max_batch: int = 256
    bucket_sizes: tuple = (16, 64, 256)
    max_inflight: int = 2
    num_workers: int = 1
    quantum_rows: int = 256


class _Block(NamedTuple):
    model: str
    X: np.ndarray           # (padded, d) assembled + zero-padded queries
    rows: int               # real rows (<= padded)
    requests: tuple         # _Request slices, in concatenation order
    t_build: float = 0.0    # obs.clock_us() at assembly (serve_queue span end)


class ContinuousBatcher:
    """Pipelined, multi-model request scheduler over PredictionEngines.

      assembler: ships the moment a worker is idle and any requests are
        pending; while every worker is busy, arrivals coalesce in the
        pending queues and are committed early (build-ahead, up to
        max_inflight) only once a full max_batch of rows is waiting;
      workers:   drain the block queue, one `engine.predict` per block,
        copy the result to the host, scatter the futures.

    Fairness: each model owns a FIFO of pending requests. Every scheduling
    round accrues `quantum_rows` of deficit to every backlogged model, the
    block goes to the most underserved one (largest deficit, oldest head
    request breaking ties), and shipping debits the rows shipped.

    Models are hot-swappable (`add_model` / `swap_model` / `remove_model`):
    what `ServeFleet` uses for residency, eviction and `observe()` updates.
    """

    DEFAULT = "default"

    def __init__(self, engines=None, config: SchedulerConfig = SchedulerConfig()):
        """engines: a single engine, a list of replicas, or {name: engine
        | [replicas]}; None starts empty (add_model later)."""
        self.config = config
        self._buckets = tuple(sorted(set(int(b) for b in config.bucket_sizes)))
        if not self._buckets:
            raise ValueError("bucket_sizes must be non-empty")
        if config.max_inflight < 1 or config.num_workers < 1:
            raise ValueError("max_inflight and num_workers must be >= 1")
        self._lock = threading.Condition()
        self._replicas: dict[str, list] = {}
        self._pending: dict[str, collections.deque] = {}
        self._deficit: dict[str, float] = {}
        self._total_rows = 0   # rows pending across all models
        self._inflight = 0     # blocks queued or executing
        self._closed = False
        self.batches_run = 0
        self.requests_served = 0
        self.rows_served = 0
        self.rows_padded = 0
        self._counter_lock = threading.Lock()
        if engines is not None:
            if not isinstance(engines, dict):
                engines = {self.DEFAULT: engines}
            for name, eng in engines.items():
                self.add_model(name, eng)
        self._blocks: queue.Queue = queue.Queue()
        self._assembler = threading.Thread(
            target=self._assemble, name="cb-assembler", daemon=True)
        self._workers = [
            threading.Thread(target=self._launch, args=(i,),
                             name=f"cb-worker-{i}", daemon=True)
            for i in range(config.num_workers)]
        self._assembler.start()
        for w in self._workers:
            w.start()

    # -- model registry -----------------------------------------------------

    def add_model(self, name: str, engine) -> None:
        replicas = list(engine) if isinstance(engine, (list, tuple)) else [engine]
        if not replicas:
            raise ValueError("need at least one engine replica")
        with self._lock:
            if name in self._replicas:
                raise ValueError(f"model {name!r} already registered")
            self._replicas[name] = replicas
            self._pending[name] = collections.deque()
            self._deficit[name] = 0.0

    def swap_model(self, name: str, engine) -> None:
        """Replace a model's engine(s) in place; its queued requests are
        served by the new engine."""
        replicas = list(engine) if isinstance(engine, (list, tuple)) else [engine]
        with self._lock:
            if name not in self._replicas:
                raise KeyError(f"model {name!r} not registered")
            self._replicas[name] = replicas

    def remove_model(self, name: str) -> None:
        """Drop a model; its pending (unassembled) requests fail at once.
        Blocks already assembled still complete."""
        with self._lock:
            self._replicas.pop(name)
            dropped = self._pending.pop(name)
            self._deficit.pop(name)
            self._total_rows -= sum(r.X.shape[0] for r in dropped)
        for r in dropped:
            if not r.future.done():
                r.future.set_exception(
                    KeyError(f"model {name!r} removed before serving"))

    def models(self) -> list[str]:
        with self._lock:
            return list(self._replicas)

    # -- client surface -----------------------------------------------------

    def submit(self, Xstar, model: str = DEFAULT,
               rid: str | None = None) -> Future:
        """Enqueue an (m, d) query for `model`; resolves to (mean, var)
        numpy arrays. `rid` tags the request in the trace (the fleet mints
        one at its edge); minted here when tracing and not given."""
        X = np.asarray(Xstar)
        if X.ndim == 1:
            X = X[None, :]
        if rid is None and obs.tracing_enabled():
            rid = obs.next_request_id()
        f: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("ContinuousBatcher is closed")
            if model not in self._pending:
                raise KeyError(f"model {model!r} not registered")
            self._pending[model].append(
                _Request(X, f, obs.clock_us(), rid or ""))
            self._total_rows += X.shape[0]
            depth = len(self._pending[model])
            self._lock.notify_all()
        obs.gauge(f"serve.queue_depth.{model}").set(depth)
        return f

    def predict(self, Xstar, model: str = DEFAULT, timeout: float | None = None):
        return self.submit(Xstar, model).result(timeout=timeout)

    def close(self) -> None:
        """Stop accepting work, fail undelivered requests, join threads."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._lock.notify_all()
        self._assembler.join()
        for _ in self._workers:
            self._blocks.put(_SENTINEL)
        for w in self._workers:
            w.join()
        with self._lock:
            leftovers = [r for q in self._pending.values() for r in q]
            for q in self._pending.values():
                q.clear()
        for r in leftovers:
            if not r.future.done():
                r.future.set_exception(
                    RuntimeError("ContinuousBatcher closed before serving"))

    def __enter__(self) -> "ContinuousBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- assembler ----------------------------------------------------------

    def _pick_model_locked(self) -> str | None:
        """Deficit-fair choice among backlogged models (caller holds lock)."""
        backlogged = [n for n, q in self._pending.items() if q]
        if not backlogged:
            return None
        for n in backlogged:
            self._deficit[n] += self.config.quantum_rows
        return max(backlogged,
                   key=lambda n: (self._deficit[n], -self._pending[n][0].t_enq))

    def _can_ship_locked(self) -> bool:
        """Ship at once when a worker is idle; while all are busy, build
        ahead (up to max_inflight) only once a full block is pending."""
        if self._total_rows == 0:
            return False
        if self._inflight >= self.config.max_inflight:
            return False
        if self._inflight < self.config.num_workers:
            return True
        return self._total_rows >= self.config.max_batch

    def _assemble(self) -> None:
        while True:
            with self._lock:
                while not self._closed and not self._can_ship_locked():
                    self._lock.wait()
                if self._closed:
                    return
                name = self._pick_model_locked()
                q = self._pending[name]
                batch = [q.popleft()]
                rows = batch[0].X.shape[0]
                while q and rows + q[0].X.shape[0] <= self.config.max_batch:
                    nxt = q.popleft()
                    batch.append(nxt)
                    rows += nxt.X.shape[0]
                self._total_rows -= rows
                self._deficit[name] = max(0.0, self._deficit[name] - rows)
                self._inflight += 1
                depth, deficit = len(q), self._deficit[name]
                inflight = self._inflight
            obs.gauge(f"serve.queue_depth.{name}").set(depth)
            obs.gauge(f"serve.deficit.{name}").set(deficit)
            obs.gauge("serve.inflight").set(inflight)
            now = obs.clock_us()
            try:
                Xp, rows = _padded_block(batch, self._buckets, now)
            except ValueError as e:  # requests of different widths
                for r in batch:
                    r.future.set_exception(e)
                with self._lock:
                    self._inflight -= 1
                    self._lock.notify_all()
                continue
            self._blocks.put(_Block(model=name, X=Xp, rows=rows,
                                    requests=tuple(batch), t_build=now))

    # -- workers ------------------------------------------------------------

    def _launch(self, worker_id: int) -> None:
        while True:
            block = self._blocks.get()
            if block is _SENTINEL:
                return
            try:
                with self._lock:
                    replicas = self._replicas.get(block.model)
                if replicas is None:
                    raise KeyError(
                        f"model {block.model!r} removed before serving")
                engine = replicas[worker_id % len(replicas)]
                t0 = obs.clock_us()
                with obs.span("serve_block", model=block.model,
                              requests=len(block.requests), rows=block.rows,
                              padded=block.X.shape[0]):
                    mean, var = _to_host(*engine.predict(block.X))
                t1 = obs.clock_us()
                _scatter(block.requests, mean, var)
                if obs.tracing_enabled():
                    _emit_request_spans(block.requests, block.model,
                                        block.t_build, t0, t1)
                with self._counter_lock:
                    self.batches_run += 1
                    self.requests_served += len(block.requests)
                    self.rows_served += block.rows
                    self.rows_padded += block.X.shape[0] - block.rows
            except Exception as e:  # reaches every caller in the block
                for r in block.requests:
                    if not r.future.done():
                        r.future.set_exception(e)
            finally:
                with self._lock:
                    self._inflight -= 1
                    inflight = self._inflight
                    self._lock.notify_all()
                obs.gauge("serve.inflight").set(inflight)
