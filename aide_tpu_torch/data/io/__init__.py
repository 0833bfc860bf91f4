"""aide_tpu_torch.data.io."""
