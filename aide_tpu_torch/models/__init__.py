"""aide_tpu_torch.models: the ported networks and their factory."""

from __future__ import annotations

from torch import nn

from aide_tpu_torch.core.registry import MODELS
from aide_tpu_torch.models.blocks import POOLS
from aide_tpu_torch.models.fuseunet import VARIANTS, FuseUNet  # noqa: F401
from aide_tpu_torch.models.unet import UNET_WIDTHS, UNet  # noqa: F401

# the FuseUNet variants by the names they register under
FUSEUNET_VARIANTS = {name: variant for variant, name in VARIANTS.items()}


def build_model(model_cfg) -> nn.Module:
    """The network a ModelConfig names, from the registry (``MODELS``): a
    FuseUNet variant or a member of the UNet family, with its norm,
    upsample, attention and remat options, or a network a user registered.
    ``packed*`` keys are accepted as no-ops (the packed layout computes the
    same network). So is ``param_dtype``: the JAX package reads it nowhere
    (``aide_tpu/core/config.py:47``; every flax module pins
    ``param_dtype=jnp.float32``), so its parameters are float32 whatever the
    key says, and the port builds float32 parameters too."""
    return MODELS.get(model_cfg.name)(model_cfg)


def build_eval_model(model_cfg) -> nn.Module:
    """The forward-only twin of ``build_model(model_cfg)``. The JAX
    package drops its packed block barrier here, a TPU layout knob the port
    does not have, so this is ``build_model``."""
    return build_model(model_cfg)


def space_needs(model_cfg) -> tuple:
    """What a space axis needs of the network a ModelConfig names: (the
    2x2 pools it descends through, so each level's rows a rank must be
    whole; its widest halo in rows, the spatial gates' dilation in the
    attention models, else the 3x3 convs' 1). Only the zoo's own
    networks are known here; a network a user registered has no entry."""
    name = model_cfg.name
    if name not in UNET_WIDTHS and name not in FUSEUNET_VARIANTS:
        raise KeyError(
            f"cannot size a space axis for model {name!r}: its pools and halo are known only "
            f"for {sorted(UNET_WIDTHS) + sorted(FUSEUNET_VARIANTS)}")
    gated = name == "unetsa" or FUSEUNET_VARIANTS.get(name, "plain") != "plain"
    return POOLS, max(1, model_cfg.attention_dilation) if gated else 1


def is_two_modal(name: str) -> bool:
    return name.startswith("fuseunet")
