"""aide_tpu_torch.engine."""
