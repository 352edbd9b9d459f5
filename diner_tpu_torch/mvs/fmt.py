"""Feature Matching Transformer (port of diner_tpu.mvs.fmt): linear
attention between reference and source features, propagated down the FPN.

Linear attention with the elu(x)+1 feature map. The reference view goes
through the 4 self-attention layers (each one's output kept); each source
view alternates self and cross attention (x4), attending to the matching
reference layer's output. The stage-1 result reaches stages 2 and 3 through
1x1 dim reduction, bilinear upsample-add and 3x3 smoothing. Submodule names
are the reference's (FMT.layers.i.attention.*_projection, linear1/2,
norm1/2, dim_reduction_1/2, smooth_1/2).

With `dtype=torch.bfloat16` the projections and convs run in bfloat16 on
float32 parameters cast at use, and the LayerNorms take their statistics in
float32 and return bfloat16; the position encoding stays float32, as in
the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from diner_tpu_torch.mvs.layers import conv_in, norm_in
from diner_tpu_torch.nn.init import lecun_normal_

# flax's LayerNorm default, which the JAX package's FMT uses
LN_EPS = 1e-6


def sine_position_encoding_2d(d_model: int, H: int, W: int, device=None):
    """(d_model, H, W) sinusoidal 2D encoding with 1-indexed positions:
    channels 4i and 4i+1 sin and cos of x, 4i+2 and 4i+3 of y."""
    y = torch.arange(1, H + 1, dtype=torch.float32,
                     device=device)[:, None].expand(H, W)
    x = torch.arange(1, W + 1, dtype=torch.float32,
                     device=device)[None].expand(H, W)
    div = torch.exp(torch.arange(0, d_model // 2, 2, dtype=torch.float32,
                                 device=device)
                    * (-math.log(10000.0) / (d_model // 2)))[:, None, None]
    pe = torch.zeros(d_model, H, W, device=device)
    pe[0::4] = torch.sin(x[None] * div)
    pe[1::4] = torch.cos(x[None] * div)
    pe[2::4] = torch.sin(y[None] * div)
    pe[3::4] = torch.cos(y[None] * div)
    return pe


def linear_attention(q, k, v, eps: float = 1e-6):
    """q: (N, L, H, D); k: (N, S, H, D); v: (N, S, H, M) -> (N, L, H, M)."""
    q = F.elu(q) + 1
    k = F.elu(k) + 1
    kv = torch.einsum("nshd,nshm->nhmd", k, v)
    z = 1.0 / (torch.einsum("nlhd,nhd->nlh", q, k.sum(dim=1)) + eps)
    return torch.einsum("nlhd,nhmd,nlh->nlhm", q, kv, z)


def _dense(cin: int, cout: int):
    lin = nn.Linear(cin, cout)
    nn.init.xavier_uniform_(lin.weight)
    nn.init.zeros_(lin.bias)
    return lin


class AttentionLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_heads = n_heads
        self.dtype = dtype
        self.query_projection = _dense(d_model, d_model)
        self.key_projection = _dense(d_model, d_model)
        self.value_projection = _dense(d_model, d_model)
        self.out_projection = _dense(d_model, d_model)

    def forward(self, queries, keys, values):
        N, L, _ = queries.shape
        S = keys.shape[1]
        H = self.n_heads
        dt = self.dtype
        q = conv_in(self.query_projection, queries, dt).reshape(N, L, H, -1)
        k = conv_in(self.key_projection, keys, dt).reshape(N, S, H, -1)
        v = conv_in(self.value_projection, values, dt).reshape(N, S, H, -1)
        return conv_in(self.out_projection,
                       linear_attention(q, k, v).reshape(N, L, -1), dt)


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.attention = AttentionLayer(d_model, n_heads, dtype)
        self.linear1 = _dense(d_model, 2 * d_model)
        self.linear2 = _dense(2 * d_model, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, source):
        dt = self.dtype
        x = norm_in(self.norm1, x + self.attention(x, source, source), dt)
        y = conv_in(self.linear2, torch.relu(conv_in(self.linear1, x, dt)),
                    dt)
        return norm_in(self.norm2, x + y, dt)


def _tokens(x):
    """(N, C, H, W) -> (N, H*W, C)."""
    return x.flatten(2).transpose(1, 2)


class FMT(nn.Module):
    def __init__(self, d_model: int = 32, n_heads: int = 8,
                 layer_names=("self", "cross") * 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layer_names = tuple(layer_names)
        self.layers = nn.ModuleList(EncoderLayer(d_model, n_heads, dtype)
                                    for _ in self.layer_names)

    def forward(self, ref_feature, src_feature=None, feat: str = "ref"):
        """feat "ref": ref (N, C, H, W) -> the list of the self layers'
        outputs (N, C, H, W). feat "src": that list as ref_feature and a
        source map (N, C, H, W) -> the transformed source map."""
        if feat == "ref":
            N, C, H, W = ref_feature.shape
            pe = sine_position_encoding_2d(C, H, W, ref_feature.device)
            x = _tokens(ref_feature + pe)
            outs = []
            for layer, name in zip(self.layers, self.layer_names):
                if name == "self":
                    x = layer(x, x)
                    outs.append(x.transpose(1, 2).reshape(N, C, H, W))
            return outs
        if feat != "src":
            raise ValueError(f"feat must be 'ref' or 'src', got {feat!r}")
        refs = [_tokens(r) for r in ref_feature]
        N, C, H, W = src_feature.shape
        pe = sine_position_encoding_2d(C, H, W, src_feature.device)
        x = _tokens(src_feature + pe)
        for i, (layer, name) in enumerate(zip(self.layers, self.layer_names)):
            x = layer(x, x) if name == "self" else layer(x, refs[i // 2])
        return x.transpose(1, 2).reshape(N, C, H, W)


def _conv(cin: int, cout: int, kernel: int):
    conv = nn.Conv2d(cin, cout, kernel, padding=(kernel - 1) // 2,
                     bias=False)
    lecun_normal_(conv.weight, cin * kernel * kernel)
    return conv


class FMTWithPathway(nn.Module):
    def __init__(self, base_channels: int = 8,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        b = base_channels
        self.dtype = dtype
        self.FMT = FMT(d_model=4 * b, dtype=dtype)
        self.dim_reduction_1 = _conv(4 * b, 2 * b, 1)
        self.dim_reduction_2 = _conv(2 * b, b, 1)
        self.smooth_1 = _conv(2 * b, 2 * b, 3)
        self.smooth_2 = _conv(b, b, 3)

    @staticmethod
    def _upsample_add(x, y):
        return F.interpolate(x, size=y.shape[-2:], mode="bilinear",
                             align_corners=False) + y

    def forward(self, features):
        """features: one {"stage1", "stage2", "stage3"} dict of NCHW maps per
        view, the reference view first."""
        out = []
        ref_list = None
        dt = self.dtype
        for i, f in enumerate(features):
            f = dict(f)
            if i == 0:
                ref_list = self.FMT(f["stage1"], feat="ref")
                f["stage1"] = ref_list[-1]
            else:
                f["stage1"] = self.FMT(ref_list, f["stage1"], feat="src")
            f["stage2"] = conv_in(self.smooth_1, self._upsample_add(
                conv_in(self.dim_reduction_1, f["stage1"], dt),
                f["stage2"]), dt)
            f["stage3"] = conv_in(self.smooth_2, self._upsample_add(
                conv_in(self.dim_reduction_2, f["stage2"], dt),
                f["stage3"]), dt)
            out.append(f)
        return out
