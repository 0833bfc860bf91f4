"""aide_tpu_torch.ops."""
