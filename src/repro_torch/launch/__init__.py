"""repro_torch.launch — process-group meshes (`mesh`) and the command-line
entry points (`serve_gp`, `train`)."""
