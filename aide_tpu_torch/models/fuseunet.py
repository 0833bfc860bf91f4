"""Two-modal FuseUNet: the plain variant and the two attention variants.

The counterpart of ``aide_tpu.models.fuseunet.FuseUNet``: two 5-level
encoders fused by channel concat [modal1, modal2] at every scale, one
decoder over the fused skips, and a 1x1 head. Variants:

* ``plain`` (``fuseunet``): modal 1 descends through the FUSED maps, so its
  blocks from level 2 on take 2x the width;
* ``sa`` (``fuseunetsa``): as plain, with a spatial-attention gate on each
  modality's block output at every level (``modal{m}_sa{k}``);
* ``sa_separate`` (``fuseunetsaseparate``): gated as ``sa``, but modal 1
  descends through its own gated maps; the fusion only feeds the skips.

Public layout as in the JAX package: inputs (B, H, W, 3) each, logits
(B, H, W, C) float32. Inside, the maps are NCHW in channels_last memory, so
the NHWC logits are a view with no copy.
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

VARIANTS = {"plain": "fuseunet", "sa": "fuseunetsa", "sa_separate": "fuseunetsaseparate"}


class FuseUNet(nn.Module):
    def __init__(
        self,
        num_classes: int = 2,
        base_width: int = 32,
        in_channels: int = 3,
        compute_dtype: str = "bfloat16",
        variant: str = "plain",
        learned_bilinear: bool = False,
        attention_reduction: int = 16,
        attention_dilation: int = 4,
        norm: str = "batch",
        group_norm_groups: int = 8,
        remat: bool = False,
    ):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown FuseUNet variant {variant!r}")
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.gated = variant != "plain"
        self.fused_descent = variant != "sa_separate"
        self.remat = remat
        # what interop.weights reads to pick the name map
        self.arch = dict(model_name=VARIANTS[variant], learned_bilinear=learned_bilinear,
                         norm=norm)
        common = dict(norm=norm, groups=group_norm_groups)
        w = base_width
        widths = [w << level for level in range(POOLS + 1)]
        for level, feats in enumerate(widths):
            prev = widths[level - 1]
            cin1 = in_channels if level == 0 else (2 * prev if self.fused_descent else prev)
            cin2 = in_channels if level == 0 else prev
            self.add_module(f"modal1_downblock{level + 1}", DownBlock(cin1, feats, **common))
            self.add_module(f"modal2_downblock{level + 1}", DownBlock(cin2, feats, **common))
            if self.gated:
                for m in (1, 2):
                    self.add_module(f"modal{m}_sa{level + 1}", SpatialAttention(
                        feats, attention_reduction, attention_dilation, norm))
        for level in range(POOLS - 1, -1, -1):
            self.add_module(f"up_block{POOLS - level}", UpBlock(
                2 * widths[level + 1], 2 * widths[level], 2 * widths[level], learned_bilinear,
                **common))
        self.last_conv1 = nn.Conv2d(2 * widths[0], num_classes, 1)

    def _encode(self, m: int, level: int, x: torch.Tensor, update_stats: bool) -> torch.Tensor:
        x = run_block(getattr(self, f"modal{m}_downblock{level + 1}"), self.remat, x, update_stats)
        if self.gated:
            x = getattr(self, f"modal{m}_sa{level + 1}")(x, update_stats) * x
        return x

    def forward(
        self, modal1: torch.Tensor, modal2: torch.Tensor, update_stats: bool = True
    ) -> torch.Tensor:
        y = modal1.permute(0, 3, 1, 2)
        x = modal2.permute(0, 3, 1, 2)
        with autocast(y, self.compute_dtype):
            fused = []
            for level in range(POOLS + 1):
                if level > 0:
                    y = max_pool_2x2(fused[-1] if self.fused_descent else y)
                    x = max_pool_2x2(x)
                y = self._encode(1, level, y, update_stats)
                x = self._encode(2, level, x, update_stats)
                fused.append(torch.cat([y, x], dim=1))
            out = fused[-1]
            for level in range(POOLS - 1, -1, -1):
                out = run_block(getattr(self, f"up_block{POOLS - level}"), self.remat,
                                fused[level], out, update_stats)
            logits = self.last_conv1(out)
        return logits.to(torch.float32).permute(0, 2, 3, 1)


def _register() -> None:
    for variant, name in VARIANTS.items():

        @MODELS.register(name)
        def factory(model_cfg, _variant=variant):
            return FuseUNet(base_width=model_cfg.base_width or 32, variant=_variant,
                            **net_options(model_cfg))


_register()
