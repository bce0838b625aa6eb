"""Device resolution and the fp32 policy.

The reference's exact path is true IEEE fp32. On Hopper a float32 matmul
may run in TF32 if asked to, and cuDNN does so by default, so both switches
are turned off here, when the package is imported. bf16 enters only where a
caller asks for `compute_dtype="bfloat16"`.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """`None` means the card; it raises when there is none rather than
    running on the CPU. Pass `device="cpu"` to run on the CPU on purpose."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)
