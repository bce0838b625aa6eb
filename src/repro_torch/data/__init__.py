"""repro_torch.data — synthetic regression datasets (numpy only)."""
