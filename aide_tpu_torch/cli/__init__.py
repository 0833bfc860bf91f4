"""aide_tpu_torch.cli: the command line (``main``) and the config presets."""
