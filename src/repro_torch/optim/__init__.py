"""Optimizers on params trees of tensors: Adam, L-BFGS, LR schedules and
the LM trainer's gradient clipping (the counterpart of `repro.optim`)."""

from .adam import AdamState, adam_init, adam_update, clip_by_global_norm
from .lbfgs import lbfgs_minimize
from .schedules import constant_lr, warmup_cosine

__all__ = [
    "AdamState", "adam_init", "adam_update", "clip_by_global_norm",
    "lbfgs_minimize",
    "constant_lr", "warmup_cosine",
]
