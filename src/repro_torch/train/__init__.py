"""repro_torch.train — the checkpoint layout, the warm-started solve engines
(`solver_state`: `WarmStartEngine` on one device, `DistWarmStartEngine` on a
mesh) and exact-GP hyperparameter training (`gp_trainer`)."""
