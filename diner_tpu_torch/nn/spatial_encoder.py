"""Pixel-aligned spatial image encoder: ResNet trunk + border positional
encoding (port of diner_tpu.nn.spatial_encoder).

The input is edge-padded by `image_padding` px and a 2D positional encoding
is written into the padded border only (zeros inside), concatenated as extra
input channels. Stage outputs are upsampled to the stem resolution (bilinear,
align_corners=True) and concatenated. Input and output are NHWC.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from diner_tpu_torch.image_ops.resize import resize_bilinear_align_corners
from diner_tpu_torch.nn.posenc import posenc, posenc_dim
from diner_tpu_torch.nn.resnet import ResNetTrunk


class SpatialEncoder(nn.Module):
    def __init__(self, backbone: str = "resnet34", num_layers: int = 4,
                 norm: str = "group", use_first_pool: bool = True,
                 image_padding: int = 0, padding_pe: int = -1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_layers = num_layers
        self.image_padding = image_padding
        self.padding_pe = padding_pe
        self.trunk = ResNetTrunk(3 + self.pe_channels(), backbone, num_layers,
                                 norm, use_first_pool, dtype)

    @property
    def latent_size(self) -> int:
        return self.trunk.latent_size

    @property
    def feature_padding(self) -> int:
        # the stem stride is 2 for the whole BasicBlock family
        if self.image_padding % 2:
            raise ValueError("image_padding must be even")
        return self.image_padding // 2

    def pe_channels(self) -> int:
        if self.padding_pe >= 0 and self.image_padding > 0:
            return posenc_dim(2, self.padding_pe, include_input=True)
        return 0

    def border_pe(self, H: int, W: int, dtype, device):
        """(Hp, Wp, C_pe) border positional encoding, zeros inside."""
        p = self.image_padding
        Hp, Wp = H + 2 * p, W + 2 * p
        ys = torch.linspace(-1.0, 1.0, Hp, dtype=dtype, device=device)
        xs = torch.linspace(-1.0, 1.0, Wp, dtype=dtype, device=device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pe = posenc(torch.stack([gx, gy], dim=-1), num_freqs=self.padding_pe,
                    freq_factor=math.pi, include_input=True)
        pe[p:Hp - p, p:Wp - p] = 0.0
        return pe

    def forward(self, imgs):
        """imgs (N, H, W, 3), ImageNet-normalized -> (N, Hf, Wf, latent)."""
        N, H, W, _ = imgs.shape
        p = self.image_padding
        x = imgs.permute(0, 3, 1, 2)
        if p > 0:
            x = F.pad(x, (p, p, p, p), mode="replicate")
        if self.pe_channels():
            pe = self.border_pe(H, W, imgs.dtype, imgs.device)
            x = torch.cat([x, pe.permute(2, 0, 1)[None].expand(N, -1, -1, -1)],
                          dim=1)
        feats = [f.permute(0, 2, 3, 1) for f in self.trunk(x)]
        out_hw = feats[0].shape[1:3]
        feats = [f if f.shape[1:3] == out_hw
                 else resize_bilinear_align_corners(f, out_hw) for f in feats]
        return torch.cat(feats, dim=-1)
