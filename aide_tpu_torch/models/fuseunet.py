"""Two-modal FuseUNet, plain variant.

The counterpart of ``aide_tpu.models.fuseunet.FuseUNet(variant="plain")``:
two 5-level encoders fused by channel concat [modal1, modal2] at every
scale, modal 1 descending through the FUSED maps, one decoder over the
fused skips, and a 1x1 head. Public layout as in the JAX package: inputs
(B, H, W, 3) each, logits (B, H, W, C) float32. Inside, the maps are NCHW
in channels_last memory, so the NHWC logits are a view with no copy.
"""

from __future__ import annotations

import torch
from torch import nn

from aide_tpu_torch.models.blocks import DownBlock, UpBlock, autocast, max_pool_2x2, resolve_dtype


class FuseUNet(nn.Module):
    def __init__(
        self,
        num_classes: int = 2,
        base_width: int = 32,
        in_channels: int = 3,
        compute_dtype: str = "bfloat16",
    ):
        super().__init__()
        self.compute_dtype = resolve_dtype(compute_dtype)
        w = base_width
        widths = [w, 2 * w, 4 * w, 8 * w, 16 * w]
        for level, feats in enumerate(widths):
            cin1 = in_channels if level == 0 else 2 * widths[level - 1]
            cin2 = in_channels if level == 0 else widths[level - 1]
            self.add_module(f"modal1_downblock{level + 1}", DownBlock(cin1, feats))
            self.add_module(f"modal2_downblock{level + 1}", DownBlock(cin2, feats))
        for level in range(3, -1, -1):
            self.add_module(
                f"up_block{4 - level}",
                UpBlock(2 * widths[level + 1], 2 * widths[level], 2 * widths[level]),
            )
        self.last_conv1 = nn.Conv2d(2 * widths[0], num_classes, 1)

    def forward(
        self, modal1: torch.Tensor, modal2: torch.Tensor, update_stats: bool = True
    ) -> torch.Tensor:
        y = modal1.permute(0, 3, 1, 2)
        x = modal2.permute(0, 3, 1, 2)
        with autocast(y, self.compute_dtype):
            fused = []
            for level in range(5):
                if level > 0:
                    y = max_pool_2x2(fused[-1])
                    x = max_pool_2x2(x)
                y = getattr(self, f"modal1_downblock{level + 1}")(y, update_stats)
                x = getattr(self, f"modal2_downblock{level + 1}")(x, update_stats)
                fused.append(torch.cat([y, x], dim=1))
            out = fused[-1]
            for level in range(3, -1, -1):
                out = getattr(self, f"up_block{4 - level}")(fused[level], out, update_stats)
            logits = self.last_conv1(out)
        return logits.to(torch.float32).permute(0, 2, 3, 1)
