"""Single-modal UNet, with or without spatial attention.

The counterpart of ``aide_tpu.models.unet.UNet``: a 5-level encoder of
widths w, 2w, 4w, 8w, 16w (a 2x2 max pool before blocks 2-5; the JAX
package's DownBlock pools inside the block), four upsample decoder blocks
over the skips, and a 1x1 head. With ``spatial_attention`` (``unetsa``) a
gate multiplies each encoder block's output, and the gated map is both the
skip and what the next level pools. Module names are the original PyTorch
code's (``down_block3.block.conv1``, ``sa2.conv4``,
``up_block2.bilinear_up.1``, ``last_conv1``). Public layout as FuseUNet's:
input (B, H, W, 3), logits (B, H, W, C) float32, autocast inside.
"""

from __future__ import annotations

import torch
from torch import nn

from aide_tpu_torch.core.registry import MODELS
from aide_tpu_torch.models.blocks import (
    POOLS,
    DownBlock,
    SpatialAttention,
    UpBlock,
    autocast,
    max_pool_2x2,
    net_options,
    resolve_dtype,
    run_block,
)

# the UNet family by registry name, with its default base widths
# (ModelConfig.base_width overrides them)
UNET_WIDTHS = {"unet": 64, "unetsa": 64, **{f"unet{w}": w for w in (2, 4, 8, 16, 32, 128)}}


class UNet(nn.Module):
    def __init__(
        self,
        num_classes: int = 2,
        base_width: int = 64,
        in_channels: int = 3,
        compute_dtype: str = "bfloat16",
        learned_bilinear: bool = False,
        spatial_attention: bool = False,
        attention_reduction: int = 16,
        attention_dilation: int = 4,
        norm: str = "batch",
        group_norm_groups: int = 8,
        remat: bool = False,
    ):
        super().__init__()
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.spatial_attention = spatial_attention
        self.remat = remat
        # what interop.weights reads to pick the name map
        self.arch = dict(model_name="unetsa" if spatial_attention else "unet",
                         learned_bilinear=learned_bilinear, norm=norm)
        common = dict(norm=norm, groups=group_norm_groups)
        w = base_width
        widths = [w << level for level in range(POOLS + 1)]
        for level, feats in enumerate(widths):
            cin = in_channels if level == 0 else widths[level - 1]
            self.add_module(f"down_block{level + 1}", DownBlock(cin, feats, **common))
            if spatial_attention:
                self.add_module(f"sa{level + 1}", SpatialAttention(
                    feats, attention_reduction, attention_dilation, norm))
        for level in range(POOLS - 1, -1, -1):
            self.add_module(f"up_block{POOLS - level}", UpBlock(
                widths[level + 1], widths[level], widths[level], learned_bilinear, **common))
        self.last_conv1 = nn.Conv2d(widths[0], num_classes, 1)

    def forward(self, image: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        x = image.permute(0, 3, 1, 2)
        with autocast(x, self.compute_dtype):
            skips = []
            for level in range(POOLS + 1):
                if level > 0:
                    x = max_pool_2x2(x)
                x = run_block(getattr(self, f"down_block{level + 1}"), self.remat, x, update_stats)
                if self.spatial_attention:
                    x = getattr(self, f"sa{level + 1}")(x, update_stats) * x
                skips.append(x)
            for level in range(POOLS - 1, -1, -1):
                x = run_block(getattr(self, f"up_block{POOLS - level}"), self.remat,
                              skips[level], x, update_stats)
            logits = self.last_conv1(x)
        return logits.to(torch.float32).permute(0, 2, 3, 1)


def _register() -> None:
    for name, width in UNET_WIDTHS.items():

        @MODELS.register(name)
        def factory(model_cfg, _width=width, _sa=name == "unetsa"):
            return UNet(base_width=model_cfg.base_width or _width, spatial_attention=_sa,
                        **net_options(model_cfg))


_register()
