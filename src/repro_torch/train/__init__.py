"""repro_torch.train — the checkpoint layout, the warm-started solve engine
(`solver_state`) and exact-GP hyperparameter training (`gp_trainer`)."""
