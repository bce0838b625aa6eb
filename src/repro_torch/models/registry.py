"""Architecture registry: --arch <id> resolution for launch/ and tests."""

from __future__ import annotations

import importlib

from .config import ArchConfig

ARCH_IDS = (
    "qwen2-moe-a2.7b",
    "granite-moe-3b-a800m",
    "seamless-m4t-large-v2",
    "smollm-360m",
    "mistral-large-123b",
    "deepseek-coder-33b",
    "olmo-1b",
    "hymba-1.5b",
    "mamba2-130m",
    "qwen2-vl-7b",
    # the paper's own workload gets first-class cells too:
    "gp-exact-1m",
)


# architectures only the port runs (no reference counterpart): resolved by
# `get_arch` like the others, listed apart so that `ARCH_IDS` and
# `list_archs()` stay the reference's
PORT_ARCH_IDS = (
    "granite-4.0-h-small",
)


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_arch(arch_id: str) -> ArchConfig:
    """The config of `arch_id`: an `ArchConfig`, or for a port-only id its
    family's own config type (`HybridMoEConfig`)."""
    if arch_id not in ARCH_IDS + PORT_ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; options: "
                       f"{ARCH_IDS + PORT_ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.CONFIG


def list_archs() -> tuple:
    return ARCH_IDS
