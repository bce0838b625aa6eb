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


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; options: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.CONFIG


def list_archs() -> tuple:
    return ARCH_IDS
