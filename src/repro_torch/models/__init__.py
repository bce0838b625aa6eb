"""The LM stack for every family (the counterpart of `repro.models`)."""

from .config import ArchConfig
from .model import (
    LM, count_active_params, count_params, decode_step, forward_hidden,
    init_decode_state, init_params, prefill, train_loss,
)
from .registry import get_arch, list_archs

__all__ = [
    "ArchConfig", "LM", "init_params", "train_loss", "forward_hidden",
    "init_decode_state", "prefill", "decode_step", "count_params",
    "count_active_params", "get_arch", "list_archs",
]
