"""aide_tpu_torch.models: the ported networks and their factory."""

from __future__ import annotations

from torch import nn

from aide_tpu_torch.models.blocks import POOLS
from aide_tpu_torch.models.fuseunet import VARIANTS, FuseUNet
from aide_tpu_torch.models.unet import UNet

# the JAX package's model registry: the UNet family with its default base
# widths (ModelConfig.base_width overrides them), and the FuseUNet variants
UNET_WIDTHS = {"unet": 64, "unetsa": 64, **{f"unet{w}": w for w in (2, 4, 8, 16, 32, 128)}}
FUSEUNET_VARIANTS = {name: variant for variant, name in VARIANTS.items()}


def build_model(model_cfg) -> nn.Module:
    """The network a ModelConfig names: a FuseUNet variant or a member of
    the UNet family, with its norm, upsample, attention and remat options.
    ``packed*`` keys are accepted as no-ops (the packed layout computes the
    same network). So is ``param_dtype``: the JAX package reads it nowhere
    (``aide_tpu/core/config.py:47``; every flax module pins
    ``param_dtype=jnp.float32``), so its parameters are float32 whatever the
    key says, and the port builds float32 parameters too."""
    name = model_cfg.name
    if name not in UNET_WIDTHS and name not in FUSEUNET_VARIANTS:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(UNET_WIDTHS) + sorted(FUSEUNET_VARIANTS)}"
        )
    common = dict(
        num_classes=model_cfg.num_classes,
        compute_dtype=model_cfg.compute_dtype,
        learned_bilinear=model_cfg.learned_bilinear,
        attention_reduction=model_cfg.attention_reduction,
        attention_dilation=model_cfg.attention_dilation,
        norm=model_cfg.norm,
        group_norm_groups=model_cfg.group_norm_groups,
        remat=model_cfg.remat,
    )
    if name in FUSEUNET_VARIANTS:
        return FuseUNet(base_width=model_cfg.base_width or 32,
                        variant=FUSEUNET_VARIANTS[name], **common)
    return UNet(base_width=model_cfg.base_width or UNET_WIDTHS[name],
                spatial_attention=name == "unetsa", **common)


def build_eval_model(model_cfg) -> nn.Module:
    """The forward-only twin of ``build_model(model_cfg)``. The JAX
    package drops its packed block barrier here, a TPU layout knob the port
    does not have, so this is ``build_model``."""
    return build_model(model_cfg)


def space_needs(model_cfg) -> tuple:
    """What a space axis needs of the network a ModelConfig names: (the
    2x2 pools it descends through, so each level's rows a rank must be
    whole; its widest halo in rows, the spatial gates' dilation in the
    attention models, else the 3x3 convs' 1)."""
    name = model_cfg.name
    gated = name == "unetsa" or FUSEUNET_VARIANTS.get(name, "plain") != "plain"
    return POOLS, max(1, model_cfg.attention_dilation) if gated else 1


def is_two_modal(name: str) -> bool:
    return name.startswith("fuseunet")
