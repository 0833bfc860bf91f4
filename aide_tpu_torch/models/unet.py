"""Single-modal UNet.

The counterpart of ``aide_tpu.models.unet.UNet`` without spatial
attention: a 5-level encoder of widths w, 2w, 4w, 8w, 16w (a 2x2 max pool
before blocks 2-5; the JAX package's DownBlock pools inside the block),
four bilinear-upsample decoder blocks over the skips, and a 1x1 head.
Module names are the original PyTorch code's (``down_block3.block.conv1``,
``up_block2.bilinear_up.1``, ``last_conv1``). Public layout as FuseUNet's:
input (B, H, W, 3), logits (B, H, W, C) float32, autocast inside.
"""

from __future__ import annotations

import torch
from torch import nn

from aide_tpu_torch.models.blocks import DownBlock, UpBlock, autocast, max_pool_2x2, resolve_dtype


class UNet(nn.Module):
    def __init__(
        self,
        num_classes: int = 2,
        base_width: int = 64,
        in_channels: int = 3,
        compute_dtype: str = "bfloat16",
    ):
        super().__init__()
        self.compute_dtype = resolve_dtype(compute_dtype)
        w = base_width
        widths = [w, 2 * w, 4 * w, 8 * w, 16 * w]
        for level, feats in enumerate(widths):
            cin = in_channels if level == 0 else widths[level - 1]
            self.add_module(f"down_block{level + 1}", DownBlock(cin, feats))
        for level in range(3, -1, -1):
            self.add_module(
                f"up_block{4 - level}", UpBlock(widths[level + 1], widths[level], widths[level])
            )
        self.last_conv1 = nn.Conv2d(widths[0], num_classes, 1)

    def forward(self, image: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        x = image.permute(0, 3, 1, 2)
        with autocast(x, self.compute_dtype):
            skips = []
            for level in range(5):
                if level > 0:
                    x = max_pool_2x2(x)
                x = getattr(self, f"down_block{level + 1}")(x, update_stats)
                skips.append(x)
            for level in range(3, -1, -1):
                x = getattr(self, f"up_block{4 - level}")(skips[level], x, update_stats)
            logits = self.last_conv1(x)
        return logits.to(torch.float32).permute(0, 2, 3, 1)
