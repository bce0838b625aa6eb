"""Process and device set-up: caches inside the checkout, the card check,
the device record of the result line, the card's name and power limit."""

from __future__ import annotations

import os
import subprocess
import sys

from .manifest import ROOT

# fixed directories inside the checkout, so that only a checkout's first run
# builds: the program's nvcc build goes to <root>/build/kernels by itself
CACHE_DIRS = {
    "TORCH_EXTENSIONS_DIR": os.path.join(ROOT, "build", "torch_extensions"),
    "TRITON_CACHE_DIR": os.path.join(ROOT, "build", "triton"),
    "CUDA_CACHE_PATH": os.path.join(ROOT, "build", "cuda_cache"),
}


def prepare_process() -> None:
    """Environment and import path of a run: the caches above, the
    program's `src/` first on the path, libraries kept from loading JAX."""
    for k, v in CACHE_DIRS.items():
        os.environ[k] = v
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = os.path.join(ROOT, "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def require_cards(chips: int) -> None:
    """Exit without a result unless `chips` CUDA cards are visible."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("gpbench: torch.cuda.is_available() is false; no result")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"gpbench: the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} visible; no result")


def power_limit() -> str:
    """`name, power.limit` as nvidia-smi reads them (read only)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def device_record(count: int, peak_bytes: int) -> dict:
    import torch

    if torch.cuda.is_available():
        kind = torch.cuda.get_device_name(0)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    return {"platform": platform, "kind": kind, "count": count,
            "memory_peak_bytes": int(peak_bytes), "power": power_limit()
            if platform == "gpu" else "none"}
