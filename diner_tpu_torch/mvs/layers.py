"""Conv blocks of the MVS nets (port of diner_tpu.mvs.layers), NCHW and
NCDHW.

Each block's submodules carry the names of the reference TransMVSNet's
(`conv`, `bn`; a DCN's `conv_offset_mask`, `weight`, `bias`), so that a
reference state dict loads into the port by its own keys. Initialization
follows the JAX package's: convs He-normal over fan-out, the DCN's offset
and mask branch zero (the op starts as a plain conv at mask 0.5). The
BatchNorms update their running statistics in train mode as flax's do
(momentum 0.9 there, the biased batch variance: `nn/resnet.py`); eval mode
is torch's own.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from diner_tpu_torch.mvs.ops import deform_conv2d
from diner_tpu_torch.nn.resnet import BatchNorm, BatchNorm3d

BN_EPS = 1e-5


def kaiming_fan_out_(w, fan_out: int):
    """He-normal over fan-out, as the JAX package's convs draw theirs."""
    with torch.no_grad():
        return w.normal_(0.0, math.sqrt(2.0 / fan_out))


def _he_conv(conv):
    w = conv.weight
    kaiming_fan_out_(w, w.shape[0] * w[0, 0].numel())
    return conv


class ConvBnRelu(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.conv = _he_conv(nn.Conv2d(cin, cout, kernel, stride,
                                       (kernel - 1) // 2, bias=False))
        self.bn = BatchNorm(cout, eps=BN_EPS)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class Conv3dBnRelu(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.conv = _he_conv(nn.Conv3d(cin, cout, kernel, stride,
                                       (kernel - 1) // 2, bias=False))
        self.bn = BatchNorm3d(cout, eps=BN_EPS)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class Deconv3dBnRelu(nn.Module):
    """ConvTranspose3d(k=3, stride=2, padding=1, output_padding=1) + BN +
    ReLU: doubles D, H and W."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.ConvTranspose3d(cin, cout, 3, stride=2, padding=1,
                                       output_padding=1, bias=False)
        kaiming_fan_out_(self.conv.weight, cout * 27)
        self.bn = BatchNorm3d(cout, eps=BN_EPS)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class DCNLayer(nn.Module):
    """Deformable conv v2 with its learned offset and mask branch: one conv
    with 3*K*K outputs, split in thirds o1, o2 and m; the offsets are
    cat(o1, o2), read as (dy, dx) pairs per tap, the mask sigmoid(m)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3):
        super().__init__()
        taps = kernel * kernel
        self.conv_offset_mask = nn.Conv2d(cin, 3 * taps, kernel,
                                          padding=(kernel - 1) // 2)
        nn.init.zeros_(self.conv_offset_mask.weight)
        nn.init.zeros_(self.conv_offset_mask.bias)
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        kaiming_fan_out_(self.weight, cout * taps)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        o1, o2, m = torch.chunk(self.conv_offset_mask(x), 3, dim=1)
        return deform_conv2d(x, torch.cat([o1, o2], dim=1), torch.sigmoid(m),
                             self.weight, self.bias)
