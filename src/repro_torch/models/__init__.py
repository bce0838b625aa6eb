"""The LM stack for the dense family (the counterpart of `repro.models`).

Prefill and cached decode (`init_decode_state`, `decode_step`) and the
other families wait for ROADMAP A2.
"""

from .config import ArchConfig
from .model import (
    LM, count_active_params, count_params, forward_hidden, init_params,
    train_loss,
)
from .registry import get_arch, list_archs

__all__ = [
    "ArchConfig", "LM", "init_params", "train_loss", "forward_hidden",
    "count_params", "count_active_params", "get_arch", "list_archs",
]
