"""repro_torch.kernels — the hand-written CUDA kernels (csrc/), their
build, their ctypes wrappers and plain versions (kmvm), the fused-pass
plan around them (ops), and the column-split autotuner of the dense
kernels (autotune)."""
