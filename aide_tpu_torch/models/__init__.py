"""aide_tpu_torch.models: the ported networks and their factory."""

from __future__ import annotations

from aide_tpu_torch.models.fuseunet import FuseUNet


def build_model(model_cfg) -> FuseUNet:
    """The network a ModelConfig names. The port has the plain two-modal
    FuseUNet with BatchNorm; ``packed*`` keys are accepted as no-ops (the
    packed layout computes the same network)."""
    if model_cfg.name != "fuseunet":
        raise NotImplementedError(
            f"model {model_cfg.name!r} is not ported yet (fuseunet is)"
        )
    if model_cfg.norm != "batch" or model_cfg.learned_bilinear or model_cfg.remat:
        raise NotImplementedError(
            "only norm='batch', learned_bilinear=False, remat=False are ported"
        )
    if model_cfg.param_dtype != "float32":
        raise NotImplementedError("only float32 params are ported")
    return FuseUNet(
        num_classes=model_cfg.num_classes,
        base_width=model_cfg.base_width or 32,
        compute_dtype=model_cfg.compute_dtype,
    )
