"""aide_tpu_torch.cli: config presets (the command line is not ported yet)."""
