"""The networks in plain float32 PyTorch: the two-modal FuseUNet (plain
variant) and the single-modal UNet, with BatchNorm, the bilinear upsample
and the 1x1 head, under the port's state-dict names, so one set of weights
loads into both.

UNet (AIDE): five levels of two conv3x3-BN-ReLU stages of widths w..16w,
a 2x2 max pool before each level after the first; four decoder levels,
each a 2x bilinear upsample (half-pixel centres), conv3x3-BN-ReLU, then
two conv3x3-BN-ReLU stages over [upsampled, skip]. FuseUNet: two such
encoders, one a modality, fused by concatenation at each level; modality
1 descends through the fused maps; the decoder runs over the fused skips.
Inputs are (B, H, W, 3), logits (B, H, W, C).

``set_precision(net, "fp8")`` computes every convolution as fp8 training
does: its input and weight rounded to float8 e4m3 and the gradient that
reaches it rounded to e5m2 (one scale a tensor), around a float32
convolution. That is the control that a lower precision has to fail.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LEVELS = 5


def _to_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` with one scale for the tensor
    (its largest magnitude at the format's largest finite value)."""
    top = torch.finfo(dtype).max
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    """Forward: the operand rounded to e4m3; backward: the gradient passes
    unchanged (it reaches the operand through the convolution, which saw
    the rounded value)."""

    @staticmethod
    def forward(ctx, x):
        return _to_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    """Forward: identity; backward: the incoming gradient rounded to e5m2,
    as fp8 training feeds a convolution's backward."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _to_fp8(g, torch.float8_e5m2)


class Conv(nn.Conv2d):
    fp8 = False

    def forward(self, x):
        if not self.fp8:
            return super().forward(x)
        y = F.conv2d(_Fp8.apply(x), _Fp8.apply(self.weight), self.bias, self.stride,
                     self.padding, self.dilation, self.groups)
        return _Fp8Grad.apply(y)


class BN(nn.Module):
    """BatchNorm: batch statistics in train mode, running ones in eval mode;
    the reference's steps leave the running statistics as they are."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, 1e-5)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, 1e-5)


class ConvBlock(nn.Module):
    def __init__(self, cin, c):
        super().__init__()
        self.conv1, self.bn1 = Conv(cin, c, 3, padding=1), BN(c)
        self.conv2, self.bn2 = Conv(c, c, 3, padding=1), BN(c)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class Down(nn.Module):
    def __init__(self, cin, c):
        super().__init__()
        self.block = ConvBlock(cin, c)

    def forward(self, x):
        return self.block(x)


class Upsample(nn.Module):
    def forward(self, x):
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class Up(nn.Module):
    def __init__(self, cin, skip, c):
        super().__init__()
        self.bilinear_up = nn.Sequential(Upsample(), Conv(cin, skip, 3, padding=1), BN(skip),
                                         nn.ReLU())
        self.block = ConvBlock(2 * skip, c)

    def forward(self, skip, x):
        return self.block(torch.cat([self.bilinear_up(x), skip], dim=1))


class UNet(nn.Module):
    def __init__(self, width: int = 64, classes: int = 2):
        super().__init__()
        w = [width << k for k in range(LEVELS)]
        for k in range(LEVELS):
            self.add_module(f"down_block{k + 1}", Down(3 if k == 0 else w[k - 1], w[k]))
        for k in range(LEVELS - 2, -1, -1):
            self.add_module(f"up_block{LEVELS - 1 - k}", Up(w[k + 1], w[k], w[k]))
        self.last_conv1 = Conv(w[0], classes, 1)

    def forward(self, image):
        x = image.permute(0, 3, 1, 2)
        skips = []
        for k in range(LEVELS):
            if k:
                x = F.max_pool2d(x, 2)
            x = getattr(self, f"down_block{k + 1}")(x)
            skips.append(x)
        for k in range(LEVELS - 2, -1, -1):
            x = getattr(self, f"up_block{LEVELS - 1 - k}")(skips[k], x)
        return self.last_conv1(x).float().permute(0, 2, 3, 1)


class FuseUNet(nn.Module):
    def __init__(self, width: int = 32, classes: int = 2):
        super().__init__()
        w = [width << k for k in range(LEVELS)]
        for k in range(LEVELS):
            self.add_module(f"modal1_downblock{k + 1}", Down(3 if k == 0 else 2 * w[k - 1], w[k]))
            self.add_module(f"modal2_downblock{k + 1}", Down(3 if k == 0 else w[k - 1], w[k]))
        for k in range(LEVELS - 2, -1, -1):
            self.add_module(f"up_block{LEVELS - 1 - k}", Up(2 * w[k + 1], 2 * w[k], 2 * w[k]))
        self.last_conv1 = Conv(2 * w[0], classes, 1)

    def forward(self, modal1, modal2):
        y, x = modal1.permute(0, 3, 1, 2), modal2.permute(0, 3, 1, 2)
        fused = []
        for k in range(LEVELS):
            if k:
                y, x = F.max_pool2d(fused[-1], 2), F.max_pool2d(x, 2)
            y = getattr(self, f"modal1_downblock{k + 1}")(y)
            x = getattr(self, f"modal2_downblock{k + 1}")(x)
            fused.append(torch.cat([y, x], dim=1))
        out = fused[-1]
        for k in range(LEVELS - 2, -1, -1):
            out = getattr(self, f"up_block{LEVELS - 1 - k}")(fused[k], out)
        return self.last_conv1(out).float().permute(0, 2, 3, 1)


def build(model: dict) -> nn.Module:
    """The network a configuration's ``model`` section names."""
    name, width = model["name"], model["base_width"]
    if name == "fuseunet":
        return FuseUNet(width, model["num_classes"])
    if name == "unet":
        return UNet(width, model["num_classes"])
    raise ValueError(f"the reference has no network {name!r}")


def set_precision(net: nn.Module, precision: str) -> nn.Module:
    """Every convolution of ``net`` in ``precision``: "float32" or "fp8"."""
    if precision not in ("float32", "fp8"):
        raise ValueError(f"unknown precision {precision!r}")
    for m in net.modules():
        if isinstance(m, Conv):
            m.fp8 = precision == "fp8"
    return net
