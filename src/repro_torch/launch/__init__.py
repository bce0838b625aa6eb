"""repro_torch.launch — process-group meshes (`mesh`), the step factories
(`steps`) and cell specs (`specs`), the dry run and its roofline (`dryrun`,
`roofline`), and the command-line entry points (`serve_gp`, `serve`,
`train`, `obs_report`, `obs_diff`)."""
