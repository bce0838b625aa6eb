"""repro_torch.kernels — the hand-written CUDA kernels (csrc/), their
build, their ctypes wrappers and plain versions (kmvm), and the fused-pass
plan around them (ops)."""
