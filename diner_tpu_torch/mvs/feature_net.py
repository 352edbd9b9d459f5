"""FeatureNet: a 3-scale FPN with deformable-conv heads (port of
diner_tpu.mvs.feature_net).

A shared conv trunk at /1, /2 and /4, a top-down pathway of nearest 2x
upsampling and 1x1 lateral adds, and per-stage heads of [1x1 or 3x3 conv]
+ (DCN + BN + ReLU) x2 + DCN. Stage channels 4b, 2b and b at /4, /2 and /1
for base channels b. Submodule names are the reference's (conv0..2,
out1..3 as Sequentials, inner1..2).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from diner_tpu_torch.mvs.layers import (BN_EPS, ConvBnRelu, DCNLayer,
                                        conv_in, norm_in)
from diner_tpu_torch.nn.init import lecun_normal_
from diner_tpu_torch.nn.resnet import BatchNorm


class _DCNHead(nn.Sequential):
    """[conv] + (DCN + BN + ReLU) x2 + DCN; the BatchNorms through
    `norm_in` in the compute dtype."""

    def __init__(self, cin: int, mid: int, out: int, first_kernel: int = 3,
                 dtype: Optional[torch.dtype] = None,
                 dcn_impl: str = "gather"):
        super().__init__(
            ConvBnRelu(cin, mid, kernel=first_kernel, dtype=dtype),
            DCNLayer(mid, mid, dtype=dtype, impl=dcn_impl),
            BatchNorm(mid, eps=BN_EPS), nn.ReLU(),
            DCNLayer(mid, mid, dtype=dtype, impl=dcn_impl),
            BatchNorm(mid, eps=BN_EPS), nn.ReLU(),
            DCNLayer(mid, out, dtype=dtype, impl=dcn_impl))
        self.dtype = dtype

    def forward(self, x):
        for m in self:
            x = norm_in(m, x, self.dtype) if isinstance(m, BatchNorm) else m(x)
        return x


def _upsample_nearest2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest-exact")


def _lateral(cin: int, cout: int):
    conv = nn.Conv2d(cin, cout, 1)
    lecun_normal_(conv.weight, cin)
    nn.init.zeros_(conv.bias)
    return conv


class FeatureNet(nn.Module):
    """dtype: the compute dtype (None: float32); dcn_impl: the heads' DCN
    implementation (`DCNLayer`)."""

    def __init__(self, base_channels: int = 8,
                 dtype: Optional[torch.dtype] = None,
                 dcn_impl: str = "gather"):
        super().__init__()
        b = base_channels
        self.dtype = dtype

        def cbr(cin, cout, kernel=3, stride=1):
            return ConvBnRelu(cin, cout, kernel, stride, dtype=dtype)

        self.conv0 = nn.Sequential(cbr(3, b), cbr(b, b))
        self.conv1 = nn.Sequential(cbr(b, 2 * b, 5, stride=2),
                                   cbr(2 * b, 2 * b), cbr(2 * b, 2 * b))
        self.conv2 = nn.Sequential(cbr(2 * b, 4 * b, 5, stride=2),
                                   cbr(4 * b, 4 * b), cbr(4 * b, 4 * b))
        self.out1 = _DCNHead(4 * b, 4 * b, 4 * b, first_kernel=1,
                             dtype=dtype, dcn_impl=dcn_impl)
        self.out2 = _DCNHead(4 * b, 4 * b, 2 * b, dtype=dtype,
                             dcn_impl=dcn_impl)
        self.out3 = _DCNHead(4 * b, 4 * b, b, dtype=dtype,
                             dcn_impl=dcn_impl)
        self.inner1 = _lateral(2 * b, 4 * b)
        self.inner2 = _lateral(b, 4 * b)

    def forward(self, x):
        """x: (N, 3, H, W) -> {"stage1": (N, 4b, H/4, W/4), "stage2":
        (N, 2b, H/2, W/2), "stage3": (N, b, H, W)}."""
        dt = self.dtype
        if dt is not None:
            x = x.to(dt)
        c0 = self.conv0(x)
        c1 = self.conv1(c0)
        c2 = self.conv2(c1)
        out = {"stage1": self.out1(c2)}
        intra = _upsample_nearest2(c2) + conv_in(self.inner1, c1, dt)
        out["stage2"] = self.out2(intra)
        intra = _upsample_nearest2(intra) + conv_in(self.inner2, c0, dt)
        out["stage3"] = self.out3(intra)
        return out
