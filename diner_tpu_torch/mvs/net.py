"""TransMVSNet, the cascade MVS network (port of diner_tpu.mvs.net).

Three stages, coarse to fine: FeatureNet FPN -> FMT linear attention ->
per stage a plane-sweep cost volume (the source views' pairwise
correlation with the reference, weighted by PixelwiseNet's view weights,
computed at stage 1 and nearest-upsampled after), a 3D UNet, softmax to a
probability volume, winner-take-all depth and photometric confidence = the
largest probability. Stage 1 sweeps the full [min, max] range; stages 2
and 3 sweep +-ndepth/2 intervals about the bilinearly upsampled previous
depth.

Inference (eval mode) runs the BatchNorm layers on their running
statistics and the FeatureNet trunk once over all B*V images, as the JAX
package's inference does. Train mode calls FeatureNet once per view, so
that BatchNorm's batch statistics are per view and its running statistics
are updated once per view, in view order, as the JAX package's shared
module is in training. The view weights and the depth handed to the next
stage carry no gradient, as in JAX.

The module tree carries the reference TransMVSNet's names (feature,
FMT_with_pathway, cost_regularization.i, DepthNet.pixel_wise_net), so that
its state dicts load by their own keys (mvs/checkpoint.py).

Options, as in the JAX package: `compute_dtype="bfloat16"` runs the convs,
DCN heads, FMT and cost volumes in bfloat16 on float32 parameters, with
the geometry, the DCN offsets, softmax, the probability volume and WTA in
float32 (`layers.conv_in`); `dcn_impl="window"` swaps the DCN heads to the
gather-free stencil (`ops.deform_conv2d_window`), with the same
parameters. `window_offset_stats` audits the stencil's exact domain.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from diner_tpu_torch.mvs.feature_net import FeatureNet
from diner_tpu_torch.mvs.fmt import FMTWithPathway
from diner_tpu_torch.mvs.layers import (Conv3dBnRelu, DCNLayer,
                                        Deconv3dBnRelu, conv_in, sigmoid)
from diner_tpu_torch.mvs.ops import (depth_range_samples, depth_wta,
                                     homo_warping)
from diner_tpu_torch.nn.init import lecun_normal_

STAGE_SCALES = (4, 2, 1)
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
# the window DCN is exact while every |k + offset| < its margin (2) - 1e-3
WINDOW_LIMIT = 2.0 - 1e-3


class PixelwiseNet(nn.Module):
    """1x1x1 3D convs + sigmoid + max over depth -> per-pixel view weight."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv0 = Conv3dBnRelu(1, 16, kernel=1, dtype=dtype)
        self.conv1 = Conv3dBnRelu(16, 8, kernel=1, dtype=dtype)
        self.conv2 = nn.Conv3d(8, 1, 1)
        lecun_normal_(self.conv2.weight, 8)
        nn.init.zeros_(self.conv2.bias)

    def forward(self, x):
        """x: (B, 1, D, H, W) similarity -> (B, 1, H, W)."""
        x = conv_in(self.conv2, self.conv1(self.conv0(x)), self.dtype)
        return sigmoid(x).amax(dim=2)


class CostRegNet(nn.Module):
    """3D UNet over (D, H, W) cost volumes; D, H and W divisible by 8."""

    def __init__(self, in_channels: int = 1, base_channels: int = 8,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        b = base_channels
        self.dtype = dtype

        def c3(cin, cout, stride=1):
            return Conv3dBnRelu(cin, cout, stride=stride, dtype=dtype)

        self.conv0 = c3(in_channels, b)
        self.conv1 = c3(b, 2 * b, stride=2)
        self.conv2 = c3(2 * b, 2 * b)
        self.conv3 = c3(2 * b, 4 * b, stride=2)
        self.conv4 = c3(4 * b, 4 * b)
        self.conv5 = c3(4 * b, 8 * b, stride=2)
        self.conv6 = c3(8 * b, 8 * b)
        self.conv7 = Deconv3dBnRelu(8 * b, 4 * b, dtype)
        self.conv9 = Deconv3dBnRelu(4 * b, 2 * b, dtype)
        self.conv11 = Deconv3dBnRelu(2 * b, b, dtype)
        self.prob = nn.Conv3d(b, 1, 3, padding=1, bias=False)
        lecun_normal_(self.prob.weight, b * 27)

    def forward(self, x):
        c0 = self.conv0(x)
        c2 = self.conv2(self.conv1(c0))
        c4 = self.conv4(self.conv3(c2))
        y = self.conv6(self.conv5(c4))
        y = c4 + self.conv7(y)
        y = c2 + self.conv9(y)
        y = c0 + self.conv11(y)
        return conv_in(self.prob, y, self.dtype)


def _fuse(proj):
    """(B, 2, 4, 4) [extrinsics, intrinsics] -> (B, 4, 4) with K @ [R|t]
    in the top three rows."""
    out = proj[:, 0].clone()
    out[:, :3, :4] = proj[:, 1, :3, :3] @ proj[:, 0, :3, :4]
    return out


class DepthNet(nn.Module):
    """One stage's cost volume, view weighting and depth regression."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.pixel_wise_net = PixelwiseNet(dtype)

    def forward(self, features, proj_mats, depth_values, cost_reg,
                view_weights=None):
        """features: per view (B, C, h, w), the reference first; proj_mats:
        (B, V, 2, 4, 4); depth_values: (B, D, h, w); view_weights: None at
        stage 1, else (B, V-1, h, w). Returns the stage's outputs and the
        view weights."""
        ref_f = features[0]
        ref_proj = _fuse(proj_mats[:, 0])
        sim_sum = 0.0
        w_sum = 1e-5
        vw_list = []
        for i, src_f in enumerate(features[1:]):
            warped = homo_warping(src_f, _fuse(proj_mats[:, i + 1]),
                                  ref_proj, depth_values)
            sim = (warped * ref_f[:, :, None]).mean(dim=1, keepdim=True)
            if view_weights is None:
                vw = self.pixel_wise_net(sim)                 # (B, 1, h, w)
                vw_list.append(vw)
            else:
                vw = view_weights[:, i:i + 1]
            sim_sum = sim_sum + sim * vw[:, :, None]
            w_sum = w_sum + vw[:, :, None]
        cost = cost_reg(sim_sum / w_sum)[:, 0]                # (B, D, h, w)
        prob_volume = torch.softmax(cost.float(), dim=1)
        out = {"depth": depth_wta(prob_volume, depth_values),
               "photometric_confidence": prob_volume.amax(dim=1),
               "prob_volume": prob_volume, "depth_values": depth_values}
        if view_weights is None:
            view_weights = torch.cat(vw_list, dim=1).detach()
        return out, view_weights


class TransMVSNet(nn.Module):
    """The full cascade. Images need H and W divisible by 32 and every
    ndepth divisible by 8, as the reference's DTU shapes (512x640, ndepths
    48/32/8) are."""

    def __init__(self, ndepths: Sequence[int] = (48, 32, 8),
                 depth_intervals_ratio: Sequence[float] = (4, 2, 1),
                 cr_base_chs: Sequence[int] = (8, 8, 8),
                 base_channels: int = 8, compute_dtype: str = "float32",
                 dcn_impl: str = "gather"):
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of "
                             f"{sorted(COMPUTE_DTYPES)}, "
                             f"got {compute_dtype!r}")
        dt = COMPUTE_DTYPES[compute_dtype]
        self.ndepths = tuple(ndepths)
        self.depth_intervals_ratio = tuple(depth_intervals_ratio)
        self.compute_dtype = compute_dtype
        self.dcn_impl = dcn_impl
        self.feature = FeatureNet(base_channels, dtype=dt, dcn_impl=dcn_impl)
        self.FMT_with_pathway = FMTWithPathway(base_channels, dtype=dt)
        self.cost_regularization = nn.ModuleList(
            CostRegNet(1, cr_base_chs[i], dtype=dt)
            for i in range(len(self.ndepths)))
        self.DepthNet = DepthNet(dt)

    def forward(self, imgs, proj_matrices, depth_values):
        """imgs: (B, V, 3, H, W); proj_matrices: {"stage1".."stage3":
        (B, V, 2, 4, 4)}; depth_values: (B, D_full), the full-range
        hypotheses. Returns each stage's outputs under "stage1".."stage3",
        and the last stage's "depth" and "photometric_confidence" at full
        resolution."""
        B, V, _, H, W = imgs.shape
        depth_interval = ((depth_values[:, -1] - depth_values[:, 0])
                          / depth_values.shape[1])
        if self.training:
            features = [self.feature(imgs[:, v]) for v in range(V)]
        else:
            fall = self.feature(imgs.reshape(B * V, 3, H, W))
            features = [{k: f.reshape(B, V, *f.shape[1:])[:, v]
                         for k, f in fall.items()} for v in range(V)]
        features = self.FMT_with_pathway(features)

        outputs = {}
        depth = view_weights = None
        for stage_idx, (nd, ratio) in enumerate(
                zip(self.ndepths, self.depth_intervals_ratio)):
            scale = STAGE_SCALES[stage_idx]
            h, w = H // scale, W // scale
            name = f"stage{stage_idx + 1}"
            if depth is None:
                cur = depth_values
            else:
                cur = F.interpolate(depth.detach()[:, None], size=(H, W),
                                    mode="bilinear", align_corners=False)[:, 0]
            step = ratio * depth_interval[:, None, None]
            drs = depth_range_samples(cur, nd, step, (B, H, W))
            drs = F.interpolate(drs, size=(h, w), mode="bilinear",
                                align_corners=False)
            if view_weights is not None:
                view_weights = F.interpolate(view_weights, size=(h, w),
                                             mode="nearest-exact")
            out, view_weights = self.DepthNet(
                [f[name] for f in features], proj_matrices[name], drs,
                self.cost_regularization[stage_idx], view_weights)
            depth = out["depth"]
            outputs[name] = out
        outputs["depth"] = depth
        outputs["photometric_confidence"] = \
            outputs[f"stage{len(self.ndepths)}"]["photometric_confidence"]
        return outputs


def window_offset_stats(net: TransMVSNet, imgs, proj_matrices, depth_values):
    """Audit the window DCN's exact domain on a batch: one forward of the
    net as it stands (eval mode for inference), returning (max_disp,
    per_layer), the largest |k + offset| over every DCN layer and a
    {layer name: largest} dict. The forward runs in eval mode (BatchNorm
    on its running statistics, which it leaves as they are).
    `ops.deform_conv2d_window` equals the gather form while max_disp <
    WINDOW_LIMIT; beyond it taps clamp to the window's edge and lose their
    offset gradient. Works with either implementation."""
    layers = {n: m for n, m in net.named_modules() if isinstance(m, DCNLayer)}
    for m in layers.values():
        m.record_disp = True
    training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(imgs, proj_matrices, depth_values)
        per_layer = {n: float(m.window_disp_max) for n, m in layers.items()}
    finally:
        net.train(training)
        for m in layers.values():
            m.record_disp = False
            m.window_disp_max = None
    return max(per_layer.values()), per_layer
