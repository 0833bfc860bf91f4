"""Shared network blocks, NCHW in ``torch.channels_last`` memory.

The counterparts of ``aide_tpu.models.blocks``: the norms, the conv, down
and up blocks, the attention gates and the refine block. Module names
follow the original PyTorch code's state_dict (``block.conv1``,
``bilinear_up.1``, ``sa3.conv4``, ...), so its ``.pkl`` checkpoints and the
JAX package's variables (``interop.weights``) load by name.

Every block's ``forward`` takes ``update_stats``: the TTA forwards run in
train-mode BatchNorm (batch statistics) without touching the running ones.
GroupNorm has no running statistics and ignores it. Train-mode BatchNorm
has one path at every world size: torch's per-channel statistics and
normalise kernels (plain versions on the CPU), folding the running
statistics from the mean and inverse std it normalised with.

``remat`` is ``torch.utils.checkpoint`` (non-reentrant) around a block, as
the JAX package wraps its blocks in ``nn.remat``. The recompute in the
backward pass runs with the BatchNorm folds switched off, so the running
statistics are folded once per forward, as flax's functional remat does.

Inside ``space_partition`` on a space axis (``core.mesh``) each rank holds
rows [s*H/S, (s+1)*H/S) of every map, and the layers compute what they
compute on whole images: a 3x3 conv (``Conv2d``, dilated or not) takes
``padding`` rows of each neighbour (``mesh.halo_rows``, zeros at the
image's edges) and pads W alone; the bilinear upsample takes one row of
each, the edge row copied at the image's edges (the clamp of the
half-pixel resize); BatchNorm's statistics span the replica group (data x
space), GroupNorm's and the channel gate's sums the space group. Pools,
1x1 convs and the transposed 2x2 conv are local. No module changes its
parameters or names for it.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from aide_tpu_torch.core import mesh
from aide_tpu_torch.ops import cuda_upsample

# the UNet family and the FuseUNet pool 2x2 before each of their levels
# after the first: POOLS + 1 levels
POOLS = 4

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def net_options(model_cfg) -> dict:
    """The ModelConfig keys that every network of the zoo takes."""
    return dict(
        num_classes=model_cfg.num_classes,
        compute_dtype=model_cfg.compute_dtype,
        learned_bilinear=model_cfg.learned_bilinear,
        attention_reduction=model_cfg.attention_reduction,
        attention_dilation=model_cfg.attention_dilation,
        norm=model_cfg.norm,
        group_norm_groups=model_cfg.group_norm_groups,
        remat=model_cfg.remat,
    )


def resolve_dtype(name: str) -> torch.dtype:
    """A ModelConfig.compute_dtype name as a torch dtype."""
    if name not in _DTYPES:
        raise ValueError(f"unknown compute_dtype {name!r}")
    return _DTYPES[name]


def autocast(x: torch.Tensor, dtype: torch.dtype):
    """The model's compute-dtype region: autocast to ``dtype`` on ``x``'s
    device, off for float32."""
    return torch.autocast(device_type=x.device.type, dtype=dtype, enabled=dtype != torch.float32)


def _stats_dtype(x: torch.Tensor) -> torch.dtype:
    """flax's norm statistics dtype: at least float32."""
    return torch.promote_types(x.dtype, torch.float32)


# whether train-mode BatchNorms take the data axis's global statistics
# (``global_batch_stats``); a module global, not a thread-local: the
# backward's remat recompute runs on autograd's own threads
_global_stats = False


@contextlib.contextmanager
def global_batch_stats(enabled: bool = True):
    """Inside, a train-mode ``BatchNorm`` on a data axis of N > 1 ranks
    (``core.mesh``) normalises with the statistics of the global batch,
    each rank holding an equal block of its rows. That is a collective in
    every forward and backward of every norm, so every rank must run the
    same ones in the same order: the train steps set it over sharded rows,
    around the forwards and the backward (where remat recomputes them).
    Outside it, every BatchNorm uses its own rows."""
    global _global_stats
    before = _global_stats
    _global_stats = enabled
    try:
        yield
    finally:
        _global_stats = before


# whether the layers run on this rank's rows of a space axis
# (``space_partition``); a module global for the same reason
_space = False


@contextlib.contextmanager
def space_partition(enabled: bool = True):
    """Inside, on a space axis of S > 1 ranks (``core.mesh``), the layers
    take this rank's rows of each image and exchange what crosses the rows'
    edges with the other shards of its space group: collectives in the
    forwards and the backward, which every rank of the group runs in the
    same order (remat's recompute issues its halos again). Outside it, or
    at S = 1, every layer computes on the rows it is given."""
    global _space
    before = _space
    _space = enabled
    try:
        yield
    finally:
        _space = before


def _partitioned() -> bool:
    return _space and mesh.space_size() > 1


def _channels(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def _memory_format(x: torch.Tensor) -> torch.memory_format:
    if not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


# torch's fused per-channel batch-norm kernels (``nn.SyncBatchNorm``'s;
# ``F.batch_norm`` runs the same on channels_last maps, its statistics as
# a variance) on a card, and their plain versions on the CPU, which has
# none: statistics and sums in float32, outputs in the input's dtype


def _stats(x, eps):
    """This rank's per-channel mean and 1 / sqrt(biased var + eps)."""
    if x.device.type == "cuda":
        return torch.batch_norm_stats(x, eps)
    xf = x.to(_stats_dtype(x))
    mean = xf.mean(dim=(0, 2, 3))
    var = ((xf - _channels(mean)) ** 2).mean(dim=(0, 2, 3))
    return mean, torch.rsqrt(var + eps)


def _combine_stats(x, mean_all, invstd_all, counts, eps):
    """The global mean and inverse std from every rank's (rows: ranks)."""
    if x.device.type == "cuda":
        # without running tensors the kernel computes in x's dtype (bf16
        # counts under autocast); given float32 ones, in float32. It folds
        # the unbiased variance into them, so they are scratch
        scratch = mean_all.new_empty((2, mean_all.shape[1]))
        return torch.batch_norm_gather_stats_with_counts(
            x, mean_all, invstd_all, scratch[0], scratch[1], 0.0, eps, counts)
    w = (counts / counts.sum()).view(-1, 1)
    mean = (w * mean_all).sum(dim=0)
    var = (w * (invstd_all.pow(-2) - eps + (mean_all - mean) ** 2)).sum(dim=0)
    return mean, torch.rsqrt(var + eps)


def _normalize(x, weight, bias, mean, invstd, eps):
    if x.device.type == "cuda":
        return torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
    y = (x.to(mean.dtype) - _channels(mean)) * _channels(invstd * weight) + _channels(bias)
    return y.to(x.dtype)


def _backward_sums(gy, x, mean, invstd, weight):
    """This rank's sum(dy) and sum(dy * (x - mean)) per channel, and its
    share of the weight's and bias's gradients."""
    if x.device.type == "cuda":
        return torch.batch_norm_backward_reduce(gy, x, mean, invstd, weight, True, True, True)
    gf = gy.to(mean.dtype)
    sum_dy = gf.sum(dim=(0, 2, 3))
    sum_dy_xmu = (gf * (x.to(mean.dtype) - _channels(mean))).sum(dim=(0, 2, 3))
    return sum_dy, sum_dy_xmu, sum_dy_xmu * invstd, sum_dy


def _backward_input(gy, x, mean, invstd, weight, sum_dy, sum_dy_xmu, counts):
    """dL/dx from the global sums of ``_backward_sums``."""
    if x.device.type == "cuda":
        return torch.batch_norm_backward_elemt(
            gy, x, mean, invstd, weight, sum_dy, sum_dy_xmu, counts)
    n = counts.sum().to(mean.dtype)
    gx = (gy.to(mean.dtype) - _channels(sum_dy / n)
          - (x.to(mean.dtype) - _channels(mean)) * _channels(invstd * invstd * sum_dy_xmu / n))
    return (gx * _channels(invstd * weight)).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _row_counts(world: int, count: int, device: torch.device):
    """Every rank's element count per channel (equal blocks of rows), as
    the fused kernels take it: float32 for the statistics, int32 for the
    backward."""
    counts = torch.full((world,), float(count), device=device)
    return counts, counts.to(torch.int32)


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode batch norm over ``group`` of ``world`` ranks, each holding
    an equal block of the batch's rows: this rank alone (``world`` 1), its
    net's data group, or its replica group under ``space_partition`` (on a
    net axis the pair's other net normalises its own activations in its
    own group). The forward takes this rank's per-channel mean and inverse
    std and, over more than one rank, all-gathers and combines them; the
    backward takes this rank's per-channel sum(dy) and sum(dy * (x - mean))
    and, over more than one rank, all-reduces them (one collective). The
    weight's and bias's gradients stay this rank's share, which the step's
    gradient all-reduce sums. Returns y and the mean and inverse std (no
    gradient), which the module folds into its running ones."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group, world):
        x = x.contiguous(memory_format=_memory_format(x))
        c = x.shape[1]
        ctx.group, ctx.world = group, world
        mean, invstd = _stats(x, eps)
        counts, ctx.counts = _row_counts(world, x.numel() // c, x.device)
        if world > 1:
            local = torch.cat([mean, invstd])
            gathered = local.new_empty(world * 2 * c)
            mesh.all_gather(gathered, local, group, "bn")
            gathered = gathered.view(world, 2, c)
            mean, invstd = _combine_stats(x, gathered[:, 0], gathered[:, 1], counts, eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.mark_non_differentiable(mean, invstd)
        return _normalize(x, weight, bias, mean, invstd, eps), mean, invstd

    @staticmethod
    def backward(ctx, gy, _mean, _invstd):
        x, weight, mean, invstd = ctx.saved_tensors
        gy = gy.contiguous(memory_format=_memory_format(x))
        sum_dy, sum_dy_xmu, gw, gb = _backward_sums(gy, x, mean, invstd, weight)
        if ctx.world > 1:
            sums = torch.cat([sum_dy, sum_dy_xmu])
            mesh.all_reduce(sums, ctx.group, "bn")
            sum_dy, sum_dy_xmu = sums.chunk(2)
        gx = _backward_input(gy, x, mean, invstd, weight, sum_dy, sum_dy_xmu, ctx.counts)
        return gx, gw, gb, None, None, None


class BatchNorm(nn.Module):
    """BatchNorm with flax semantics.

    Train mode normalizes with the batch statistics (``_BatchNormTrain``)
    and, when ``update_stats``, folds them into the running ones as flax
    does: ``running = 0.9*running + 0.1*batch`` with the BIASED batch
    variance, here ``invstd^-2 - eps`` of the statistics it normalised
    with. ``nn.BatchNorm2d`` folds in the unbiased one, which is why this
    is its own module. Eval mode uses the running stats. ``fold`` is
    cleared while a remat block recomputes its forward.

    Inside ``global_batch_stats`` on a data axis of N > 1 ranks (or under
    ``space_partition``, on the N blocks of data x space) the statistics
    are those of the global batch (one collective a forward, one a
    backward), and every rank folds the same running statistics. Outside
    it, or at N = 1, they are this rank's rows' and no collective runs.
    Under remat the recompute runs its collective again, in the same order
    on every rank."""

    def __init__(self, channels: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.fold = True
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
        group, world = mesh.replicas(_partitioned()) if _global_stats else (None, 1)
        y, mean, invstd = _BatchNormTrain.apply(x, self.weight, self.bias, self.eps, group, world)
        if update_stats and self.fold:
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(invstd.pow(-2).sub_(self.eps), self.momentum)
        return y


def group_count(channels: int, groups: int) -> int:
    """flax's group count: ``min(groups, C)``, stepped down until it
    divides C (``aide_tpu.models.blocks.Norm``)."""
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


class GroupNorm(nn.Module):
    """GroupNorm with flax semantics: epsilon 1e-6, statistics in at least
    float32 as flax's fast variance ``max(0, E[x^2] - E[x]^2)`` over (H, W, C/g),
    the output in the input's dtype. No running statistics: train and eval
    mode give the same output, and ``update_stats`` is ignored."""

    def __init__(self, channels: int, groups: int = 8, eps: float = 1e-6):
        super().__init__()
        self.num_groups = group_count(channels, groups)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        b, c, h, w = x.shape
        # splitting C is a view in channels_last memory too
        xg = x.to(_stats_dtype(x)).reshape(b, self.num_groups, c // self.num_groups, h, w)
        if _partitioned():
            # the whole image's sums: this shard's, summed over the space group
            sums = mesh.space_all_reduce(torch.stack([xg.sum(dim=(2, 3, 4)),
                                                      (xg * xg).sum(dim=(2, 3, 4))]))
            n = (c // self.num_groups) * h * mesh.space_size() * w
            mean, sq = (sums / n)[..., None, None, None]
        else:
            mean = xg.mean(dim=(2, 3, 4), keepdim=True)
            sq = (xg * xg).mean(dim=(2, 3, 4), keepdim=True)
        var = torch.clamp(sq - mean * mean, min=0.0)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(b, c, h, w)
        y = y * self.weight.view(1, c, 1, 1) + self.bias.view(1, c, 1, 1)
        return y.to(x.dtype)


def Norm(channels: int, kind: str = "batch", groups: int = 8) -> nn.Module:
    """The norm factory of ``aide_tpu.models.blocks.Norm``: 'batch' or
    'group' (with flax's group count)."""
    if kind == "batch":
        return BatchNorm(channels)
    if kind == "group":
        return GroupNorm(channels, groups)
    raise ValueError(f"unknown norm kind {kind!r}")


@contextlib.contextmanager
def _no_fold(module: nn.Module):
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.fold = False
    try:
        yield
    finally:
        for m in norms:
            m.fold = True


def run_block(module: nn.Module, remat: bool, *args):
    """``module(*args)``, rematerialised in the backward pass when ``remat``
    and gradients are on (the recompute does not fold BN statistics)."""
    if not (remat and torch.is_grad_enabled()):
        return module(*args)
    return checkpoint(
        module, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _no_fold(module)),
    )


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that, under ``space_partition``, takes its H padding
    from the space neighbours' rows (``mesh.halo_rows``: ``padding`` rows,
    the dilation's reach, in the dtype the conv consumes under autocast)
    and pads W alone. Outside it, ``nn.Conv2d``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.padding[0]
        if not (r and _partitioned()):
            return super().forward(x)
        kind = x.device.type
        if torch.is_autocast_enabled(kind):
            x = x.to(torch.get_autocast_dtype(kind))
        return F.conv2d(mesh.halo_rows(x, r), self.weight, self.bias, self.stride,
                        (0, self.padding[1]), self.dilation, self.groups)


class ConvBlock(nn.Module):
    """Two conv3x3 -> norm -> relu stages."""

    def __init__(self, cin: int, features: int, norm: str = "batch", groups: int = 8):
        super().__init__()
        self.conv1 = Conv2d(cin, features, 3, padding=1)
        self.bn1 = Norm(features, norm, groups)
        self.conv2 = Conv2d(features, features, 3, padding=1)
        self.bn2 = Norm(features, norm, groups)

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x), update_stats))
        return F.relu(self.bn2(self.conv2(x), update_stats))


class DownBlock(nn.Module):
    """ConvBlock under the name ``block`` (pooling is the caller's)."""

    def __init__(self, cin: int, features: int, norm: str = "batch", groups: int = 8):
        super().__init__()
        self.block = ConvBlock(cin, features, norm, groups)

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        return self.block(x, update_stats)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample with half-pixel centres (jax.image.resize):
    ``ops.cuda_upsample.upsample2x``, the CUDA kernels on a card and their
    plain versions on the CPU, in the autocast dtype inside the model's
    autocast region. Under ``space_partition``: one halo row of each
    neighbour, the edge row copied at the image's top and bottom (where the
    resize clamps), then the resize and rows [2, 2h + 2) of it. While
    ``torch.export`` traces (the serving artifact, which must hold no call
    into this package), ``F.interpolate``."""
    if torch.compiler.is_exporting():
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
    if not _partitioned():
        return cuda_upsample.upsample2x(x)
    h = x.shape[2]
    return cuda_upsample.upsample2x(mesh.halo_rows(x, 1, edge=True))[:, :, 2:2 * h + 2]


class Upsample2x(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample2x_bilinear(x)


class UpsampleConv(nn.Sequential):
    """2x upsample, norm, relu: the original code's ``bilinear_up``
    Sequential. Bilinear resize + conv3x3 (the conv is ``.1``, the norm
    ``.2``), or with ``learned`` a ConvTranspose(k2, s2) (``.0``, the norm
    ``.1``)."""

    def __init__(self, cin: int, features: int, learned: bool = False, norm: str = "batch",
                 groups: int = 8):
        up = [nn.ConvTranspose2d(cin, features, 2, stride=2)] if learned else [
            Upsample2x(), Conv2d(cin, features, 3, padding=1)]
        super().__init__(*up, Norm(features, norm, groups), nn.ReLU())

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        *up, norm, relu = self
        for m in up:
            x = m(x)
        return relu(norm(x, update_stats))


class UpBlock(nn.Module):
    """Upsample, concat [upsampled, skip], ConvBlock."""

    def __init__(self, cin: int, skip_features: int, features: int, learned: bool = False,
                 norm: str = "batch", groups: int = 8):
        super().__init__()
        self.bilinear_up = UpsampleConv(cin, skip_features, learned, norm, groups)
        self.block = ConvBlock(2 * skip_features, features, norm, groups)

    def forward(self, skip: torch.Tensor, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        x = self.bilinear_up(x, update_stats)
        return self.block(torch.cat([x, skip], dim=1), update_stats)


class ChannelAttention(nn.Module):
    """Squeeze-excite channel gate: (B, C, 1, 1) sigmoid weights from the
    spatial mean through two dense layers (``fc1``, ``fc2``)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        mid = max(1, channels // reduction)
        self.fc1 = nn.Linear(channels, mid)
        self.fc2 = nn.Linear(mid, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _partitioned():
            # the whole image's mean: this shard's sums (at least f32) over
            # the space group
            total = mesh.space_all_reduce(x.sum(dim=(2, 3), dtype=_stats_dtype(x)))
            mean = (total / (x.shape[2] * mesh.space_size() * x.shape[3])).to(x.dtype)
        else:
            mean = x.mean(dim=(2, 3))
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(mean))))
        return y[:, :, None, None]


class _DilatedGate(nn.Module):
    """1x1 reduce to max(1, C/reduction), two dilated 3x3 convs, 1x1 to one
    channel, a norm of one group (``conv1``-``conv4``, ``bn``): the spatial
    branch of SpatialAttention and BottleneckAttention, before the sigmoid."""

    def __init__(self, channels: int, reduction: int, dilation: int, norm: str):
        super().__init__()
        mid = max(1, channels // reduction)
        self.conv1 = nn.Conv2d(channels, mid, 1)
        self.conv2 = Conv2d(mid, mid, 3, padding=dilation, dilation=dilation)
        self.conv3 = Conv2d(mid, mid, 3, padding=dilation, dilation=dilation)
        self.conv4 = nn.Conv2d(mid, 1, 1)
        self.bn = Norm(1, norm, 1)

    def spatial(self, x: torch.Tensor, update_stats: bool) -> torch.Tensor:
        y = self.conv3(self.conv2(self.conv1(x)))
        return self.bn(self.conv4(y), update_stats)


class SpatialAttention(_DilatedGate):
    """Dilated-conv spatial gate: (B, 1, H, W) sigmoid weights."""

    def __init__(self, channels: int, reduction: int = 16, dilation: int = 4, norm: str = "batch"):
        super().__init__(channels, reduction, dilation, norm)

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        return torch.sigmoid(self.spatial(x, update_stats))


class BottleneckAttention(_DilatedGate):
    """BAM-style combined gate: x + sigmoid(channel + spatial) * x."""

    def __init__(self, channels: int, reduction: int = 16, dilation: int = 4, norm: str = "batch"):
        super().__init__(channels, reduction, dilation, norm)
        self.ca = ChannelAttention(channels, reduction)

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        gate = torch.sigmoid(self.ca(x) + self.spatial(x, update_stats))
        return x + gate * x


class CAUpBlock(nn.Module):
    """Up block with a channel-attention gate on the fused features;
    ``residual`` adds the ungated features back."""

    def __init__(self, cin: int, skip_features: int, features: int, residual: bool = False,
                 learned: bool = False, reduction: int = 16, norm: str = "batch",
                 groups: int = 8):
        super().__init__()
        self.residual = residual
        self.bilinear_up = UpsampleConv(cin, skip_features, learned, norm, groups)
        self.ca = ChannelAttention(2 * skip_features, reduction)
        self.block = ConvBlock(2 * skip_features, features, norm, groups)

    def forward(self, skip: torch.Tensor, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        x = torch.cat([self.bilinear_up(x, update_stats), skip], dim=1)
        gated = self.ca(x) * x
        return self.block(gated + x if self.residual else gated, update_stats)


class FeatureRefine(nn.Module):
    """Residual refine: relu(x + norm(conv(relu(norm(conv(x))))))."""

    def __init__(self, features: int, norm: str = "batch", groups: int = 8):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, padding=1)
        self.bn1 = Norm(features, norm, groups)
        self.conv2 = Conv2d(features, features, 3, padding=1)
        self.bn2 = Norm(features, norm, groups)

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), update_stats))
        return F.relu(x + self.bn2(self.conv2(y), update_stats))
