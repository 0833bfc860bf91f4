"""aide_tpu_torch.evaluation."""
