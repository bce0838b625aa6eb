"""repro_torch.data — synthetic regression datasets (numpy only) and the
synthetic token pipeline for the LM trainer."""

from .synthetic import (
    DATASET_SPECS, RegressionSplits, make_regression_dataset, whiten_splits,
)
from .tokens import TokenPipeline, token_batch_specs

__all__ = [
    "DATASET_SPECS", "RegressionSplits", "make_regression_dataset",
    "whiten_splits", "TokenPipeline", "token_batch_specs",
]
