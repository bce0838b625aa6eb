"""ServeFleet — resident multi-model serving with streaming posterior updates.

The counterpart of `repro.serve.fleet`. One process, many trained GPs: the
fleet keeps an LRU of PosteriorArtifacts keyed by content digest
(`artifact_digest`, the same digest in both packages), loads and warms a
model the first time traffic names it, and evicts the least recently used
resident beyond `capacity`, dropping its engines and artifact so their
device memory frees.

Requests go through the pipelined `ContinuousBatcher` (per-model queues,
deficit-fair scheduling, assembly overlapping compute). Each completed
request lands in its model's `obs.SLOTracker` (`serve.slo.<name>`), the
per-model p50/p99/QPS the `serve_gp` launcher prints.

`observe(name, X_new, y_new)` absorbs streaming observations through
`update_prediction_cache`: the operator grows to n + m rows, PCG restarts
from the zero-padded mean cache under the previous batch's preconditioner
zero-row-extended, and the LOVE factorization grows blockwise. The result
is a new artifact (meta carries `updated_from` and `update_batches`) that
replaces the old one under the same name without dropping queued
requests. The fleet lock is held through the update, so a `submit` that
must load or touch a model waits behind it.

Device: engine replicas are placed on the fleet's device, `None` meaning
the card (it raises when there is none) and "cpu" the CPU on purpose; a
bare "cuda" spreads `replicas` over the node's cards.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.core.kernels_math import params_map
from repro_torch.core.operators import make_operator
from repro_torch.core.predcache import update_prediction_cache
from repro_torch.device import resolve_device

from .artifact import (
    PosteriorArtifact,
    artifact_digest,
    load_artifact,
    save_artifact,
)
from .batching import ContinuousBatcher, SchedulerConfig
from .engine import PredictionEngine


class FleetConfig(NamedTuple):
    """capacity: resident models (LRU beyond it).
    chunk_size / backend: per-engine settings (backend None = the
    artifact's own).
    replicas: engine replicas per model, one per card up to the cards the
    fleet's device spans; worker i of the scheduler drives replica
    i % replicas.
    warmup: run one chunk per engine at load, so first traffic never pays
    the kernel build.
    scheduler: the ContinuousBatcher settings.
    slo_window_s: trailing window of the per-model QPS.
    slo_target_ms: per-request latency target; each completed request past
    it bumps `serve.slo_breach.<name>`, and the summaries report `breaches`
    and `burn_rate`."""

    capacity: int = 4
    chunk_size: int = 1024
    backend: str | None = None
    replicas: int = 1
    warmup: bool = True
    scheduler: SchedulerConfig = SchedulerConfig()
    slo_window_s: float = 60.0
    slo_target_ms: float | None = None


class _Resident:
    """One loaded model: its digest, its artifact on the fleet's first
    device, its engine replicas and the preconditioner carried across
    observe() batches."""

    __slots__ = ("digest", "artifact", "engines", "precond", "names")

    def __init__(self, digest, artifact, engines):
        self.digest = digest
        self.artifact = artifact
        self.engines = engines
        self.precond = None   # built on the first observe(), extended after
        self.names = set()


class ServeFleet:
    """LRU fleet of PredictionEngines behind one continuous scheduler."""

    def __init__(self, config: FleetConfig = FleetConfig(), device=None):
        if config.capacity < 1:
            raise ValueError("fleet capacity must be >= 1")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            self._devices = [torch.device("cuda", i)
                             for i in range(torch.cuda.device_count())] or [dev]
        else:
            self._devices = [dev]
        self.config = config
        self._sources: dict[str, object] = {}   # name -> dir | artifact
        self._name_digest: dict[str, str] = {}  # name -> resident digest
        self._residents: OrderedDict[str, _Resident] = OrderedDict()
        self._lock = threading.RLock()
        self._batcher = ContinuousBatcher(None, config.scheduler)
        self._closed = False

    @property
    def device(self) -> torch.device:
        """Where artifacts live and updates run (the first replica's)."""
        return self._devices[0]

    # -- registry / residency ----------------------------------------------

    def register(self, name: str, source) -> None:
        """Declare a model: `source` is an artifact directory (loaded on
        first traffic) or an in-process PosteriorArtifact."""
        with self._lock:
            if name in self._sources:
                raise ValueError(f"model {name!r} already registered")
            self._sources[name] = source

    def models(self) -> list[str]:
        with self._lock:
            return list(self._sources)

    def resident(self) -> list[str]:
        """Names with a loaded artifact, least to most recently used
        (names sharing one content digest ride one residency slot)."""
        with self._lock:
            return [n for res in self._residents.values()
                    for n in sorted(res.names)]

    def digest(self, name: str) -> str:
        """Content digest of the model serving `name` (loads it)."""
        return self._ensure(name).digest

    def _ensure(self, name: str) -> _Resident:
        with self._lock:
            if self._closed:
                raise RuntimeError("ServeFleet is closed")
            digest = self._name_digest.get(name)
            if digest is not None:
                self._residents.move_to_end(digest)
                return self._residents[digest]
            source = self._sources.get(name)
            if source is None:
                raise KeyError(f"model {name!r} not registered")
            with obs.span("fleet_load", model=name):
                artifact = (_place(source, self.device)
                            if isinstance(source, PosteriorArtifact)
                            else load_artifact(source, device=self.device))
                digest = artifact_digest(artifact)
                res = self._residents.get(digest)
                if res is None:
                    res = _Resident(digest, artifact,
                                    self._make_engines(artifact))
                    self._residents[digest] = res
                    obs.counter("serve.fleet.loads").inc()
                else:
                    # the same content under a second name shares engines
                    self._residents.move_to_end(digest)
            res.names.add(name)
            self._name_digest[name] = digest
            self._batcher.add_model(name, res.engines)
            self._evict_over_capacity()
            obs.gauge("serve.fleet.resident").set(len(self._residents))
            return res

    def _make_engines(self, artifact: PosteriorArtifact) -> list:
        num = max(1, min(self.config.replicas, len(self._devices)))
        kwargs = dict(chunk_size=self.config.chunk_size)
        if self.config.backend is not None:
            kwargs["backend"] = self.config.backend
        engines = []
        for dev in self._devices[:num]:
            eng = PredictionEngine(artifact, device=dev, **kwargs)
            if self.config.warmup:
                eng.warmup()
            engines.append(eng)
        return engines

    def _evict_over_capacity(self) -> None:
        while len(self._residents) > self.config.capacity:
            digest, res = self._residents.popitem(last=False)
            for n in res.names:
                self._batcher.remove_model(n)
                self._name_digest.pop(n, None)
            # the fleet holds the only engine/artifact references: dropping
            # them releases the device memory
            res.engines = []
            res.artifact = None
            obs.counter("serve.fleet.evictions").inc()

    # -- serving ------------------------------------------------------------

    @property
    def batcher(self) -> ContinuousBatcher:
        """The underlying scheduler (launch and padding counters)."""
        return self._batcher

    def submit(self, name: str, Xstar):
        """Future of (mean, var) for `name`; loads the model if needed. The
        request ID is minted here, the serving edge."""
        self._ensure(name)
        t0 = time.monotonic()
        rows = 1 if getattr(Xstar, "ndim", 2) == 1 else len(Xstar)
        rid = obs.next_request_id() if obs.tracing_enabled() else None
        fut = self._batcher.submit(Xstar, model=name, rid=rid)
        tracker = obs.registry().slo(f"serve.slo.{name}")
        tracker.window_s = self.config.slo_window_s
        tracker.target_ms = self.config.slo_target_ms

        def _record(f):
            if f.exception() is None:
                breached = tracker.record(time.monotonic() - t0, rows)
                if breached:
                    obs.counter(f"serve.slo_breach.{name}").inc()
                    obs.instant("slo_breach", model=name, rid=rid or "")

        fut.add_done_callback(_record)
        return fut

    def predict(self, name: str, Xstar, timeout: float | None = None):
        return self.submit(name, Xstar).result(timeout=timeout)

    def stats(self) -> dict:
        """Per-model SLO summaries (p50/p99 latency ms, windowed QPS)."""
        with self._lock:
            names = list(self._sources)
        return {n: obs.registry().slo(f"serve.slo.{n}").summary()
                for n in names}

    # -- streaming updates --------------------------------------------------

    def observe(self, name: str, X_new, y_new, *,
                v0: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                save_to: str | None = None, **update_kwargs) -> str:
        """Absorb m new observations into `name`'s posterior; returns the
        new artifact's digest. `v0` / `generator` give the Lanczos start
        vector of a compacting update (None = a generator seeded with the
        update's batch number, as the reference's key). The new artifact
        replaces the old one under every name it served (queued requests
        see the swap per block); `save_to` also persists it."""
        with self._lock:
            res = self._ensure(name)
            art = res.artifact
            if not art.meta.get("has_y", False):
                raise ValueError(
                    f"model {name!r} cannot absorb observations: its "
                    "artifact does not carry training targets "
                    "(meta['has_y'] is False)")
            dev = self.device
            X_new = torch.as_tensor(X_new, device=dev).to(art.X.dtype)
            if X_new.ndim == 1:
                X_new = X_new[None, :]
            y_new = torch.as_tensor(y_new, device=dev).to(art.y.dtype).reshape(-1)
            if X_new.shape[0] != y_new.shape[0]:
                raise ValueError(
                    f"X_new has {X_new.shape[0]} rows but y_new has "
                    f"{y_new.shape[0]}")
            batches = int(art.meta.get("update_batches", 0))
            if v0 is None and generator is None:
                generator = torch.Generator(device=dev).manual_seed(batches + 1)
            X_ext = torch.cat([art.X, X_new], dim=0)
            y_ext = torch.cat([art.y, y_new], dim=0)
            cfg = art.config._replace(geom=None)
            if cfg.plan is not None:
                # the sparsity plan is a function of X: rebuilt over the
                # extended inputs with the same tile and margin
                from repro_torch.sparse import build_plan

                cfg = cfg._replace(plan=build_plan(
                    cfg.kernel, X_ext, art.params,
                    tile=cfg.plan.tile, margin=cfg.plan.margin))
            op = make_operator(cfg, X_ext, art.params, device=dev)
            upd_kw = dict(
                precond_rank=int(art.meta.get("precond_rank", 100)),
                lanczos_rank=int(art.meta.get("lanczos_rank", 128)),
                pred_tol=float(art.meta.get("pred_tol", 0.01)),
            )
            upd_kw.update(update_kwargs)
            with obs.span("fleet_observe", model=name, m=int(X_new.shape[0])):
                upd = update_prediction_cache(
                    op, y_ext, art.cache(), v0=v0, generator=generator,
                    precond=res.precond, **upd_kw)
            meta = dict(art.meta)
            meta["n"] = int(X_ext.shape[0])
            meta["update_batches"] = batches + 1
            meta["updated_from"] = res.digest
            meta["solve_rel_residual"] = float(
                torch.max(upd.cache.solve_rel_residual))
            meta["lanczos_rank"] = int(upd.cache.var_Q.shape[1])
            new_art = PosteriorArtifact(
                config=cfg, params=art.params, X=X_ext, y=y_ext,
                mean_cache=upd.cache.mean_cache, var_Q=upd.cache.var_Q,
                var_T_chol=upd.cache.var_T_chol,
                solve_rel_residual=upd.cache.solve_rel_residual, meta=meta)
            new_digest = artifact_digest(new_art)
            engines = self._make_engines(new_art)
            new_res = _Resident(new_digest, new_art, engines)
            new_res.precond = upd.precond
            new_res.names = set(res.names)
            # swap under every name the old digest served; in-memory
            # sources follow the update, so a reload after eviction does
            # not bring the stale posterior back
            del self._residents[res.digest]
            self._residents[new_digest] = new_res
            for n in new_res.names:
                self._name_digest[n] = new_digest
                self._batcher.swap_model(n, engines)
                if isinstance(self._sources.get(n), PosteriorArtifact):
                    self._sources[n] = new_art
            obs.counter("serve.fleet.updates").inc()
            obs.counter("serve.fleet.update_cg_iters").inc(
                int(torch.max(upd.mean_iters)))
            obs.histogram("serve.fleet.update_rows").observe(int(upd.num_new))
            if save_to is not None:
                save_artifact(save_to, new_art)
            return new_digest

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._batcher.close()
        with self._lock:
            self._residents.clear()
            self._name_digest.clear()

    def __enter__(self) -> "ServeFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _place(artifact: PosteriorArtifact, device) -> PosteriorArtifact:
    """The artifact with every array on `device` (its content and digest
    unchanged)."""
    def put(a):
        return a.to(device)

    return artifact._replace(
        params=params_map(put, artifact.params), X=put(artifact.X),
        y=put(artifact.y), mean_cache=put(artifact.mean_cache),
        var_Q=put(artifact.var_Q), var_T_chol=put(artifact.var_T_chol),
        solve_rel_residual=put(artifact.solve_rel_residual))
