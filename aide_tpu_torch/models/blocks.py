"""Shared network blocks, NCHW in ``torch.channels_last`` memory.

The counterparts of ``aide_tpu.models.blocks`` that the plain FuseUNet and
the UNet use. Module names follow the original PyTorch code's state_dict
(``block.conv1``, ``bilinear_up.1``, ...), so its ``.pkl`` checkpoints and
the JAX package's variables (``interop.weights``) load by name.

Every block's ``forward`` takes ``update_stats``: the TTA forwards run in
train-mode BatchNorm (batch statistics) without touching the running ones.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def resolve_dtype(name: str) -> torch.dtype:
    """A ModelConfig.compute_dtype name as a torch dtype."""
    if name not in _DTYPES:
        raise ValueError(f"unknown compute_dtype {name!r}")
    return _DTYPES[name]


def autocast(x: torch.Tensor, dtype: torch.dtype):
    """The model's compute-dtype region: autocast to ``dtype`` on ``x``'s
    device, off for float32."""
    return torch.autocast(device_type=x.device.type, dtype=dtype, enabled=dtype != torch.float32)


class Norm(nn.Module):
    """BatchNorm with flax semantics.

    Train mode normalizes with the batch statistics and, when
    ``update_stats``, folds them into the running ones as flax does:
    ``running = 0.9*running + 0.1*batch`` with the BIASED batch variance
    (mean(x^2) - mean(x)^2). ``nn.BatchNorm2d`` folds in the unbiased one,
    which is why this is its own module. Eval mode uses the running stats."""

    def __init__(self, channels: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                False, 0.0, self.eps,
            )
        if update_stats:
            with torch.no_grad():
                xf = x.detach().to(torch.float32)
                mean = xf.mean(dim=(0, 2, 3))
                var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
                self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
                self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class ConvBlock(nn.Module):
    """Two conv3x3 -> norm -> relu stages."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 3, padding=1)
        self.bn1 = Norm(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.bn2 = Norm(features)

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x), update_stats))
        return F.relu(self.bn2(self.conv2(x), update_stats))


class DownBlock(nn.Module):
    """ConvBlock under the name ``block`` (pooling is the caller's)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.block = ConvBlock(cin, features)

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        return self.block(x, update_stats)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample with half-pixel centres (jax.image.resize)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class Upsample2x(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample2x_bilinear(x)


class UpsampleConv(nn.Sequential):
    """2x bilinear upsample, conv3x3, norm, relu: the original code's
    ``bilinear_up`` Sequential, so the conv is ``.1`` and the norm ``.2``."""

    def __init__(self, cin: int, features: int):
        super().__init__(
            Upsample2x(), nn.Conv2d(cin, features, 3, padding=1), Norm(features), nn.ReLU()
        )

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        x = self[1](self[0](x))
        return self[3](self[2](x, update_stats))


class UpBlock(nn.Module):
    """Upsample, concat [upsampled, skip], ConvBlock."""

    def __init__(self, cin: int, skip_features: int, features: int):
        super().__init__()
        self.bilinear_up = UpsampleConv(cin, skip_features)
        self.block = ConvBlock(2 * skip_features, features)

    def forward(self, skip: torch.Tensor, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        x = self.bilinear_up(x, update_stats)
        return self.block(torch.cat([x, skip], dim=1), update_stats)
