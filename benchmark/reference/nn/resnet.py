"""BasicBlock ResNet trunk for pixel-aligned features (port of
diner_tpu.nn.resnet).

Maps run NCHW inside the trunk (cuDNN's layout). With a compute dtype set,
each convolution casts its input and weight to it, while the norms run in
float32 and return float32, as flax does when bf16 activations meet f32 norm
parameters. Norm epsilons follow flax: BatchNorm 1e-5, GroupNorm 1e-6 (torch's
GroupNorm default is 1e-5). In train mode BatchNorm updates its running
variance with the biased batch variance, as flax does (`BatchNorm`).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.nn.resnetfc import FP8, fp8_round



def world_size() -> int:
    """One process: the reference never runs across ranks."""
    return 1

STAGE_BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}
STAGE_CHANNELS = (64, 128, 256, 512)


class _FlaxBatchStats:
    """BatchNorm with flax's running statistics (momentum 0.9 there, 0.1
    here): in train mode it normalizes with the batch mean and biased
    variance, as torch does, and updates the running variance with that
    biased variance too (torch updates it with the unbiased one). Eval is
    torch's own. The statistics reduce over every axis but the channels
    (axis 1), so one forward serves 2D and 3D maps.

    Across ranks (a process group of more than one), train mode normalizes
    over the global batch, as the JAX package's global mesh does: the
    ranks' sums, sums of squares and counts go through one all-reduce that
    autograd differentiates (SyncBatchNorm's way), and the variance is
    flax's mean(x^2) - mean(x)^2, clipped at 0."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        dims = (0, *range(2, x.dim()))
        if world_size() > 1:
            return self._forward_synced(x, dims)
        with torch.no_grad():
            self.running_mean.lerp_(x.mean(dims), self.momentum)
            self.running_var.lerp_(x.var(dims, unbiased=False),
                                   self.momentum)
            self.num_batches_tracked += 1
        # torch.batch_norm, not F.batch_norm: flax normalizes a channel of
        # one value (to the bias), where F.batch_norm raises
        return torch.batch_norm(x, self.weight, self.bias, None, None, True,
                                0.0, self.eps, torch.backends.cudnn.enabled)

    def _forward_synced(self, x, dims):
        from torch.distributed.nn.functional import all_reduce

        C = x.shape[1]
        count = x.new_full((1,), x.numel() // C)
        stats = all_reduce(torch.cat([x.sum(dims), (x * x).sum(dims),
                                      count]))
        n = stats[-1]
        mean = stats[:C] / n
        var = torch.clamp(stats[C:2 * C] / n - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        shape = (1, C) + (1,) * (x.dim() - 2)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return ((x - mean.view(shape)) * scale.view(shape)
                + self.bias.view(shape))


class BatchNorm(_FlaxBatchStats, nn.BatchNorm2d):
    """BatchNorm2d with flax's running statistics (`_FlaxBatchStats`)."""


class BatchNorm3d(_FlaxBatchStats, nn.BatchNorm3d):
    """BatchNorm3d with flax's running statistics (`_FlaxBatchStats`)."""


def make_norm(kind: str, channels: int) -> nn.Module:
    if kind == "batch":
        return BatchNorm(channels, eps=1e-5, momentum=0.1)
    if kind == "group":
        return nn.GroupNorm(min(32, channels), channels, eps=1e-6)
    raise ValueError(f"unknown norm {kind!r}")


def make_conv(c_in: int, c_out: int, k: int, stride: int = 1) -> nn.Conv2d:
    """Bias-free conv, He-normal over fan_out like the flax trunk."""
    conv = nn.Conv2d(c_in, c_out, k, stride=stride, padding=k // 2,
                     bias=False)
    nn.init.kaiming_normal_(conv.weight, mode="fan_out", nonlinearity="relu")
    return conv


def conv_norm(x, conv: nn.Conv2d, norm: nn.Module,
              dtype: Optional[torch.dtype]):
    """conv in the compute dtype, then the norm in float32."""
    if dtype == FP8:
        x = F.conv2d(fp8_round(x), fp8_round(conv.weight), None, conv.stride,
                     conv.padding)
    elif dtype is not None:
        x = F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                     conv.padding)
    else:
        x = conv(x)
    return norm(x.float())


class BasicBlock(nn.Module):
    def __init__(self, c_in: int, channels: int, stride: int = 1,
                 norm: str = "batch", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv_0 = make_conv(c_in, channels, 3, stride)
        self.norm_0 = make_norm(norm, channels)
        self.conv_1 = make_conv(channels, channels, 3)
        self.norm_1 = make_norm(norm, channels)
        self.downsample_conv = self.downsample_norm = None
        if stride != 1 or c_in != channels:
            self.downsample_conv = make_conv(c_in, channels, 1, stride)
            self.downsample_norm = make_norm(norm, channels)

    def forward(self, x):
        y = F.relu(conv_norm(x, self.conv_0, self.norm_0, self.dtype))
        y = conv_norm(y, self.conv_1, self.norm_1, self.dtype)
        residual = x
        if self.downsample_conv is not None:
            residual = conv_norm(x, self.downsample_conv,
                                 self.downsample_norm, self.dtype)
        return F.relu(y + residual)


class ResNetTrunk(nn.Module):
    """First `num_layers` stages of a BasicBlock ResNet on NCHW input.

    Returns [conv1+norm+relu (64, /2), layer1 (64, /4), layer2 (128, /8),
    layer3 (256, /16), layer4 (512, /32)][:num_layers].
    """

    def __init__(self, in_channels: int, backbone: str = "resnet34",
                 num_layers: int = 4, norm: str = "batch",
                 use_first_pool: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.backbone = backbone
        self.num_layers = num_layers
        self.use_first_pool = use_first_pool
        self.dtype = dtype
        self.conv1 = make_conv(in_channels, 64, 7, 2)
        self.norm1 = make_norm(norm, 64)
        self.stages = []
        c_in = 64
        for stage in range(min(num_layers - 1, 4)):
            names = []
            for blk in range(STAGE_BLOCKS[backbone][stage]):
                stride = 2 if (stage > 0 and blk == 0) else 1
                name = f"layer{stage + 1}_block{blk}"
                self.add_module(name, BasicBlock(c_in, STAGE_CHANNELS[stage],
                                                 stride, norm, dtype))
                c_in = STAGE_CHANNELS[stage]
                names.append(name)
            self.stages.append(names)

    @property
    def latent_size(self) -> int:
        return [0, 64, 128, 256, 512, 1024][self.num_layers]

    def forward(self, x) -> List[torch.Tensor]:
        y = F.relu(conv_norm(x, self.conv1, self.norm1, self.dtype))
        feats = [y]
        for stage, names in enumerate(self.stages):
            if stage == 0 and self.use_first_pool:
                y = F.max_pool2d(y, 3, stride=2, padding=1)
            for name in names:
                y = getattr(self, name)(y)
            feats.append(y)
        return feats
