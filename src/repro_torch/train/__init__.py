"""repro_torch.train — the checkpoint layout (training itself is not
ported yet)."""
