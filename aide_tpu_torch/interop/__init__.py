"""aide_tpu_torch.interop."""
