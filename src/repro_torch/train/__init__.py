"""repro_torch.train — the checkpoint layout and `CheckpointManager`, elastic
rescale (`reshard`, `validate_divisibility`), the warm-started solve engines
(`solver_state`: `WarmStartEngine` on one device, `DistWarmStartEngine` on a
mesh), exact-GP hyperparameter training and the SGPR / SVGP baseline
trainers and the deep-kernel-learning trainer (`gp_trainer`), and the fault-tolerant LM training loop
(`trainer`)."""

from .checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from .elastic import reshard, validate_divisibility
from .gp_trainer import (
    DKLTrainConfig, GPTrainConfig, fit_dkl, fit_exact_gp, fit_sgpr, fit_svgp,
)
from .solver_state import (
    DistWarmStartEngine,
    SolverState,
    WarmStartConfig,
    WarmStartEngine,
    param_drift,
)
from .trainer import TrainLoopConfig, TrainLoopResult, run_train_loop

__all__ = [
    "CheckpointManager", "load_checkpoint", "save_checkpoint",
    "reshard", "validate_divisibility",
    "GPTrainConfig", "fit_exact_gp", "fit_sgpr", "fit_svgp",
    "DKLTrainConfig", "fit_dkl",
    "DistWarmStartEngine", "SolverState", "WarmStartConfig",
    "WarmStartEngine", "param_drift",
    "TrainLoopConfig", "TrainLoopResult", "run_train_loop",
]
