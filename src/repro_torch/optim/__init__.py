"""Optimizers on params trees of tensors: Adam, L-BFGS, LR schedules (the
counterpart of `repro.optim`, without the LM trainer's gradient clipping)."""

from .adam import AdamState, adam_init, adam_update
from .lbfgs import lbfgs_minimize
from .schedules import constant_lr, warmup_cosine

__all__ = [
    "AdamState", "adam_init", "adam_update", "lbfgs_minimize",
    "constant_lr", "warmup_cosine",
]
