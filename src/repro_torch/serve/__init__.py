"""repro_torch.serve — posterior artifacts and a batched GP serve path.

    artifact    PosteriorArtifact: versioned save/load (the reference's
                format 3) of hyperparameters, train inputs and targets, the
                mean and Lanczos variance caches; `artifact_digest`;
                `posterior_from_mean_cache` (a mesh-solved mean cache)
    engine      PredictionEngine: restore onto a KernelOperator backend on
                one device; fixed-chunk predict(Xstar)
    batching    MicroBatcher: closed size/deadline request queue

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
from .batching import BatcherConfig, MicroBatcher
from .engine import PredictionEngine

__all__ = [
    "ARTIFACT_VERSION",
    "BatcherConfig",
    "MicroBatcher",
    "PosteriorArtifact",
    "PredictionEngine",
    "artifact_digest",
    "fit_posterior",
    "load_artifact",
    "posterior_from_mean_cache",
    "save_artifact",
]
