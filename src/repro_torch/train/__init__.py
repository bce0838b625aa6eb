"""repro_torch.train — the checkpoint layout and `CheckpointManager`, the
warm-started solve engines (`solver_state`: `WarmStartEngine` on one device,
`DistWarmStartEngine` on a mesh), exact-GP hyperparameter training and the
SGPR / SVGP baseline trainers (`gp_trainer`)."""

from .checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from .gp_trainer import GPTrainConfig, fit_exact_gp, fit_sgpr, fit_svgp

__all__ = [
    "CheckpointManager", "load_checkpoint", "save_checkpoint",
    "GPTrainConfig", "fit_exact_gp", "fit_sgpr", "fit_svgp",
]
