"""Conditioned residual MLP, the NeRF field network (port of
diner_tpu.nn.resnetfc).

Input is (latent | features) along the last axis; the latent is injected per
block through linear maps before `combine_layer`, where the view axis is
mean-reduced. With a compute dtype set, every linear casts its input, weight
and bias to it, the view mean stays in that dtype, and the output is cast to
float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def _kaiming_linear(d_in: int, d_out: int, bias: bool = True) -> nn.Linear:
    lin = nn.Linear(d_in, d_out, bias=bias)
    nn.init.kaiming_normal_(lin.weight, mode="fan_in", nonlinearity="relu")
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


def linear(x, lin: nn.Linear, dtype: Optional[torch.dtype]):
    if dtype is None:
        return lin(x)
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


class ResnetBlockFC(nn.Module):
    """Two-layer residual block; fc_1 starts at zero (identity block)."""

    def __init__(self, size: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.fc_0 = _kaiming_linear(size, size)
        self.fc_1 = nn.Linear(size, size)
        nn.init.zeros_(self.fc_1.weight)
        nn.init.zeros_(self.fc_1.bias)

    def forward(self, x):
        net = linear(F.relu(x), self.fc_0, self.dtype)
        return x + linear(F.relu(net), self.fc_1, self.dtype)


class ResnetFC(nn.Module):
    def __init__(self, d_in: int, d_out: int = 4, n_blocks: int = 5,
                 d_latent: int = 0, d_hidden: int = 128,
                 combine_layer: int = 1000,
                 dtype: Optional[torch.dtype] = None,
                 out_bias_init: Optional[Sequence[float]] = None,
                 zero_init_out_channels: Sequence[int] = ()):
        super().__init__()
        if d_in <= 0:
            raise ValueError("ResnetFC needs d_in > 0")
        self.d_in, self.d_latent = d_in, d_latent
        self.n_blocks, self.combine_layer = n_blocks, combine_layer
        self.dtype = dtype
        self.lin_in = _kaiming_linear(d_in, d_hidden)
        n_z = min(combine_layer, n_blocks) if d_latent > 0 else 0
        self.lin_z = nn.ModuleList(_kaiming_linear(d_latent, d_hidden)
                                   for _ in range(n_z))
        self.blocks = nn.ModuleList(ResnetBlockFC(d_hidden, dtype)
                                    for _ in range(n_blocks))
        self.lin_out = _kaiming_linear(d_hidden, d_out)
        with torch.no_grad():
            for c in zero_init_out_channels:
                self.lin_out.weight[c] = 0.0
            if out_bias_init is not None:
                self.lin_out.bias.copy_(torch.tensor(out_bias_init))

    def forward(self, zx, combine_axis: int = 1):
        """zx (..., V, ..., d_latent + d_in) -> (..., d_out) float32, with
        the view axis `combine_axis` mean-reduced at `combine_layer`."""
        if zx.shape[-1] != self.d_latent + self.d_in:
            raise ValueError(f"expected {self.d_latent + self.d_in} input "
                             f"channels, got {zx.shape[-1]}")
        if self.dtype is not None:
            zx = zx.to(self.dtype)
        z = zx[..., : self.d_latent]
        x = linear(zx[..., self.d_latent:], self.lin_in, self.dtype)
        for blkid, block in enumerate(self.blocks):
            if blkid == self.combine_layer:
                x = x.mean(dim=combine_axis)
            if blkid < len(self.lin_z):
                x = x + linear(z, self.lin_z[blkid], self.dtype)
            x = block(x)
        return linear(F.relu(x), self.lin_out, self.dtype).float()
