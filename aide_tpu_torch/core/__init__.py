"""aide_tpu_torch.core."""

from aide_tpu_torch.core.registry import LOSSES, MODELS, TASKS  # noqa: F401
