"""FeatureNet: a 3-scale FPN with deformable-conv heads (port of
diner_tpu.mvs.feature_net).

A shared conv trunk at /1, /2 and /4, a top-down pathway of nearest 2x
upsampling and 1x1 lateral adds, and per-stage heads of [1x1 or 3x3 conv]
+ (DCN + BN + ReLU) x2 + DCN. Stage channels 4b, 2b and b at /4, /2 and /1
for base channels b. Submodule names are the reference's (conv0..2,
out1..3 as Sequentials, inner1..2).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from diner_tpu_torch.mvs.layers import BN_EPS, ConvBnRelu, DCNLayer
from diner_tpu_torch.nn.init import lecun_normal_
from diner_tpu_torch.nn.resnet import BatchNorm


class _DCNHead(nn.Sequential):
    def __init__(self, cin: int, mid: int, out: int, first_kernel: int = 3):
        super().__init__(
            ConvBnRelu(cin, mid, kernel=first_kernel),
            DCNLayer(mid, mid), BatchNorm(mid, eps=BN_EPS), nn.ReLU(),
            DCNLayer(mid, mid), BatchNorm(mid, eps=BN_EPS), nn.ReLU(),
            DCNLayer(mid, out))


def _upsample_nearest2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest-exact")


def _lateral(cin: int, cout: int):
    conv = nn.Conv2d(cin, cout, 1)
    lecun_normal_(conv.weight, cin)
    nn.init.zeros_(conv.bias)
    return conv


class FeatureNet(nn.Module):
    def __init__(self, base_channels: int = 8):
        super().__init__()
        b = base_channels
        self.conv0 = nn.Sequential(ConvBnRelu(3, b), ConvBnRelu(b, b))
        self.conv1 = nn.Sequential(ConvBnRelu(b, 2 * b, 5, stride=2),
                                   ConvBnRelu(2 * b, 2 * b),
                                   ConvBnRelu(2 * b, 2 * b))
        self.conv2 = nn.Sequential(ConvBnRelu(2 * b, 4 * b, 5, stride=2),
                                   ConvBnRelu(4 * b, 4 * b),
                                   ConvBnRelu(4 * b, 4 * b))
        self.out1 = _DCNHead(4 * b, 4 * b, 4 * b, first_kernel=1)
        self.out2 = _DCNHead(4 * b, 4 * b, 2 * b)
        self.out3 = _DCNHead(4 * b, 4 * b, b)
        self.inner1 = _lateral(2 * b, 4 * b)
        self.inner2 = _lateral(b, 4 * b)

    def forward(self, x):
        """x: (N, 3, H, W) -> {"stage1": (N, 4b, H/4, W/4), "stage2":
        (N, 2b, H/2, W/2), "stage3": (N, b, H, W)}."""
        c0 = self.conv0(x)
        c1 = self.conv1(c0)
        c2 = self.conv2(c1)
        out = {"stage1": self.out1(c2)}
        intra = _upsample_nearest2(c2) + self.inner1(c1)
        out["stage2"] = self.out2(intra)
        intra = _upsample_nearest2(intra) + self.inner2(c0)
        out["stage3"] = self.out3(intra)
        return out
