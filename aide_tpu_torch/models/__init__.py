"""aide_tpu_torch.models: the ported networks and their factory."""

from __future__ import annotations

from torch import nn

from aide_tpu_torch.models.fuseunet import FuseUNet
from aide_tpu_torch.models.unet import UNet

# the JAX package's model registry names the port has, with their default
# base widths (ModelConfig.base_width overrides them)
UNET_WIDTHS = {"unet": 64, **{f"unet{w}": w for w in (2, 4, 8, 16, 32, 128)}}


def build_model(model_cfg) -> nn.Module:
    """The network a ModelConfig names: the plain two-modal FuseUNet or the
    single-modal UNet family, with BatchNorm. ``packed*`` keys are accepted
    as no-ops (the packed layout computes the same network)."""
    name = model_cfg.name
    if name != "fuseunet" and name not in UNET_WIDTHS:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP Queue 1 item 11); "
            f"the port has fuseunet and {sorted(UNET_WIDTHS)}"
        )
    if model_cfg.norm != "batch" or model_cfg.learned_bilinear or model_cfg.remat:
        raise NotImplementedError(
            "only norm='batch', learned_bilinear=False, remat=False are ported "
            "(ROADMAP Queue 1 item 11)"
        )
    if model_cfg.param_dtype != "float32":
        raise NotImplementedError("only float32 params are ported")
    if name == "fuseunet":
        return FuseUNet(
            num_classes=model_cfg.num_classes,
            base_width=model_cfg.base_width or 32,
            compute_dtype=model_cfg.compute_dtype,
        )
    return UNet(
        num_classes=model_cfg.num_classes,
        base_width=model_cfg.base_width or UNET_WIDTHS[name],
        compute_dtype=model_cfg.compute_dtype,
    )
