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

A block built with `dtype=torch.bfloat16` computes as flax's `dtype=`
does: the parameters stay float32 and are cast at use, the convolutions
take their input and kernel in bfloat16, and the norms take their
statistics in float32 and return bfloat16 (`conv_in`, `norm_in`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from diner_tpu_torch.mvs.ops import deform_conv2d, deform_conv2d_window
from diner_tpu_torch.nn.resnet import BatchNorm, BatchNorm3d

BN_EPS = 1e-5
DCN_IMPLS = {"gather": deform_conv2d, "window": deform_conv2d_window}


def conv_in(layer: nn.Module, x, dtype: Optional[torch.dtype]):
    """A conv, transposed conv or linear layer run in `dtype`: input,
    weight and bias cast at use, and the bias added to the rounded
    product, as flax adds it. None runs the layer as it is."""
    if dtype is None:
        return layer(x)
    x = x.to(dtype)
    w = layer.weight.to(dtype)
    if isinstance(layer, nn.Linear):
        y = F.linear(x, w)
    elif isinstance(layer, nn.ConvTranspose3d):
        y = F.conv_transpose3d(x, w, None, layer.stride, layer.padding,
                               layer.output_padding)
    else:
        y = layer._conv_forward(x, w, None)
    if layer.bias is None:
        return y
    b = layer.bias.to(dtype)
    return y + (b if isinstance(layer, nn.Linear)
                else b.reshape(-1, *([1] * (y.dim() - 2))))


def norm_in(norm: nn.Module, x, dtype: Optional[torch.dtype]):
    """A norm with its statistics in float32, returned in `dtype`."""
    if dtype is None:
        return norm(x)
    return norm(x.float()).to(dtype)


def sigmoid(x):
    """1 / (1 + exp(-x)), each op in x's dtype: the JAX package's sigmoid
    rounds so in a bfloat16 call (torch.sigmoid rounds once)."""
    return 1 / (1 + torch.exp(-x))


def kaiming_fan_out_(w, fan_out: int):
    """He-normal over fan-out, as the JAX package's convs draw theirs."""
    with torch.no_grad():
        return w.normal_(0.0, math.sqrt(2.0 / fan_out))


def _he_conv(conv):
    w = conv.weight
    kaiming_fan_out_(w, w.shape[0] * w[0, 0].numel())
    return conv


class ConvBnRelu(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv = _he_conv(nn.Conv2d(cin, cout, kernel, stride,
                                       (kernel - 1) // 2, bias=False))
        self.bn = BatchNorm(cout, eps=BN_EPS)

    def forward(self, x):
        return torch.relu(norm_in(self.bn, conv_in(self.conv, x, self.dtype),
                                  self.dtype))


class Conv3dBnRelu(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv = _he_conv(nn.Conv3d(cin, cout, kernel, stride,
                                       (kernel - 1) // 2, bias=False))
        self.bn = BatchNorm3d(cout, eps=BN_EPS)

    def forward(self, x):
        return torch.relu(norm_in(self.bn, conv_in(self.conv, x, self.dtype),
                                  self.dtype))


class Deconv3dBnRelu(nn.Module):
    """ConvTranspose3d(k=3, stride=2, padding=1, output_padding=1) + BN +
    ReLU: doubles D, H and W."""

    def __init__(self, cin: int, cout: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.ConvTranspose3d(cin, cout, 3, stride=2, padding=1,
                                       output_padding=1, bias=False)
        kaiming_fan_out_(self.conv.weight, cout * 27)
        self.bn = BatchNorm3d(cout, eps=BN_EPS)

    def forward(self, x):
        return torch.relu(norm_in(self.bn, conv_in(self.conv, x, self.dtype),
                                  self.dtype))


class DCNLayer(nn.Module):
    """Deformable conv v2 with its learned offset and mask branch: one conv
    with 3*K*K outputs, split in thirds o1, o2 and m; the offsets are
    cat(o1, o2), read as (dy, dx) pairs per tap, the mask sigmoid(m).

    impl "gather" (the reference's semantics, `ops.deform_conv2d`) or
    "window" (the gather-free stencil, `ops.deform_conv2d_window`, exact
    while every |k + offset| < 2 - 1e-3): the parameters are the same, so
    a checkpoint of either runs with the other. The offsets stay float32
    in a bfloat16 layer. With `record_disp` set, a forward keeps the
    largest |k + offset| of its taps in `window_disp_max` (see
    `net.window_offset_stats`)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 dtype: Optional[torch.dtype] = None, impl: str = "gather"):
        super().__init__()
        if impl not in DCN_IMPLS:
            raise ValueError(
                f"DCNLayer impl must be 'gather' or 'window', got {impl!r}")
        self.impl = impl
        self.dtype = dtype
        self.kernel = kernel
        self.record_disp = False
        self.window_disp_max = None
        taps = kernel * kernel
        self.conv_offset_mask = nn.Conv2d(cin, 3 * taps, kernel,
                                          padding=(kernel - 1) // 2)
        nn.init.zeros_(self.conv_offset_mask.weight)
        nn.init.zeros_(self.conv_offset_mask.bias)
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        kaiming_fan_out_(self.weight, cout * taps)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        dt = self.dtype
        o1, o2, m = torch.chunk(conv_in(self.conv_offset_mask, x, dt), 3,
                                dim=1)
        offset = torch.cat([o1, o2], dim=1).float()
        if self.record_disp:
            self.window_disp_max = self._disp_max(offset)
        fn = DCN_IMPLS[self.impl]
        if dt is None:
            return fn(x, offset, sigmoid(m), self.weight, self.bias)
        return fn(x.to(dt), offset, sigmoid(m), self.weight.to(dt),
                  self.bias.to(dt))

    def _disp_max(self, offset):
        K = self.kernel
        N, _, H, W = offset.shape
        k = torch.arange(K * K, device=offset.device)
        kyx = torch.stack([k // K, k % K], dim=-1).float() - (K - 1) // 2
        disp = offset.detach().reshape(N, K * K, 2, H, W) + kyx[
            None, :, :, None, None]
        return disp.abs().amax()
