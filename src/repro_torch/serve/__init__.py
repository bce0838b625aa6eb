"""repro_torch.serve — posterior artifacts and a batched, multi-model GP
serve path.

    artifact    PosteriorArtifact: versioned save/load (the reference's
                format 3) of hyperparameters, train inputs and targets, the
                mean and Lanczos variance caches; `artifact_digest`, the
                content identity the fleet keys on;
                `posterior_from_mean_cache` (a mesh-solved mean cache)
    engine      PredictionEngine: restore onto a KernelOperator backend on
                one device; fixed-chunk predict(Xstar)
    batching    MicroBatcher: closed size/deadline request queue;
                ContinuousBatcher: pipelined multi-model scheduler
                (deficit-fair per-model queues, assembly/compute overlap)
    fleet       ServeFleet: LRU of resident artifacts by content digest,
                lazy load and warmup, per-model SLO tracking, and streaming
                `observe()` updates through the incremental predcache path

CLI: `python -m repro_torch.launch.serve_gp`.
"""

from .artifact import (
    ARTIFACT_VERSION,
    PosteriorArtifact,
    artifact_digest,
    fit_posterior,
    load_artifact,
    posterior_from_mean_cache,
    save_artifact,
)
from .batching import (
    BatcherConfig,
    ContinuousBatcher,
    MicroBatcher,
    SchedulerConfig,
)
from .engine import PredictionEngine
from .fleet import FleetConfig, ServeFleet

__all__ = [
    "ARTIFACT_VERSION",
    "BatcherConfig",
    "ContinuousBatcher",
    "FleetConfig",
    "MicroBatcher",
    "PosteriorArtifact",
    "PredictionEngine",
    "SchedulerConfig",
    "ServeFleet",
    "artifact_digest",
    "fit_posterior",
    "load_artifact",
    "posterior_from_mean_cache",
    "save_artifact",
]
