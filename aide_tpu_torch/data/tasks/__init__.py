"""aide_tpu_torch.data.tasks."""
