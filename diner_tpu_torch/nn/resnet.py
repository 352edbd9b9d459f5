"""BasicBlock ResNet trunk for pixel-aligned features (port of
diner_tpu.nn.resnet).

Maps run NCHW inside the trunk (cuDNN's layout). With a compute dtype set,
each convolution casts its input and weight to it, while the norms run in
float32 and return float32, as flax does when bf16 activations meet f32 norm
parameters. Norm epsilons follow flax: BatchNorm 1e-5, GroupNorm 1e-6 (torch's
GroupNorm default is 1e-5).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

STAGE_BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}
STAGE_CHANNELS = (64, 128, 256, 512)


def make_norm(kind: str, channels: int) -> nn.Module:
    if kind == "batch":
        return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)
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
    if dtype is not None:
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
