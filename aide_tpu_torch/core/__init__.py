"""aide_tpu_torch.core."""
