"""MVS core ops (port of diner_tpu.mvs.ops): deformable convolution as a
bilinear gather, plane-sweep homography warping, cascade depth hypotheses
and winner-take-all depth.

Layouts are PyTorch's: NCHW feature maps, (N, 2*K*K, H, W) offsets and
(N, K*K, H, W) masks, as torchvision's deform_conv2d takes them. The
bilinear fetches go through a quad-packed (`pack_quad`), 1-pixel
zero-padded NHWC copy of the features, so that one row gather returns all
four corners of a sample, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from diner_tpu_torch.image_ops.grid_sample import pack_quad


def _padded_quad(x):
    """NCHW (N, C, H, W) -> (N * (H+2) * (W+2), 4C): the quad-packed rows of
    the map padded with one pixel of zeros on every side."""
    N, C, H, W = x.shape
    xq = pack_quad(F.pad(x.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1)))
    return xq.reshape(N * (H + 2) * (W + 2), 4 * C)


def _cells(sy, sx, H: int, W: int):
    """Sample positions (N, P) -> the rows of their cells in the flattened
    `_padded_quad` map and the in-cell weights, each (N * P,). Clipping to
    [-1, size] keeps every bilinear window inside the padded map, and a
    sample that lies wholly outside the image reads stored zeros only."""
    N = sy.shape[0]
    sx = sx.clamp(-1.0, float(W))
    sy = sy.clamp(-1.0, float(H))
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    base = (torch.arange(N, device=sy.device) * ((H + 2) * (W + 2)))[:, None]
    idx = base + (y0.long() + 1) * (W + 2) + (x0.long() + 1)
    return idx.reshape(-1), (sx - x0).reshape(-1), (sy - y0).reshape(-1)


def _corner_weights(wx, wy):
    """In-cell weights (...) -> the bilinear weights (..., 4) of a quad
    row's slots [self, right, down, diag]."""
    return torch.stack([(1 - wx) * (1 - wy), wx * (1 - wy),
                        (1 - wx) * wy, wx * wy], dim=-1)


def deform_conv2d(x, offset, mask, weight, bias=None):
    """Modulated deformable convolution (DCNv2): stride 1, "same" padding,
    square kernel, zeros outside the image.

    x: (N, C, H, W); offset: (N, 2*K*K, H, W), (dy, dx) of tap k at
    channels 2k and 2k+1 (taps row-major); mask: (N, K*K, H, W); weight:
    (O, C, K, K); bias: (O,). Returns (N, O, H, W) in float32.

    The taps are gathered one at a time and each one's product with its
    weight slice is added to the output, so that only one tap's rows are
    live at once. A tap's four corners, scaled by their bilinear weights
    and the mask, go through one matmul with the weight slice repeated four
    times, which sums them.
    """
    N, C, H, W = x.shape
    O, _, K, _ = weight.shape
    pad = (K - 1) // 2
    dev = x.device
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    gy = gy.reshape(1, H * W)
    gx = gx.reshape(1, H * W)
    off = offset.float().reshape(N, K * K, 2, H * W)
    m = mask.reshape(N, K * K, H * W)
    xq = _padded_quad(x)
    w = weight.reshape(O, C, K * K)
    out = torch.zeros(N * H * W, O, dtype=torch.float32, device=dev)
    for t in range(K * K):
        ky, kx = t // K - pad, t % K - pad
        idx, wx, wy = _cells(gy + ky + off[:, t, 0], gx + kx + off[:, t, 1],
                             H, W)
        wq = _corner_weights(wx, wy) * m[:, t].reshape(-1, 1)
        rows = xq.index_select(0, idx).reshape(-1, 4, C) * wq[..., None]
        out = out + rows.reshape(-1, 4 * C) @ w[:, :, t].t().repeat(4, 1)
    out = out.reshape(N, H, W, O).permute(0, 3, 1, 2)
    if bias is not None:
        out = out + bias[:, None, None]
    return out


def homo_warping(src_fea, src_proj, ref_proj, depth_values):
    """Plane-sweep warp of source features into the reference frustum.

    src_fea: (B, C, H, W); src_proj, ref_proj: (B, 4, 4), intrinsics
    premultiplied into [R|t]; depth_values: (B, D, H, W) or (B, D).
    Returns (B, C, D, H, W). Samples with z < 1e-6 read zeros.
    """
    B, C, H, W = src_fea.shape
    D = depth_values.shape[1]
    dev = src_fea.device
    f32 = torch.float32
    proj = src_proj.to(f32) @ torch.linalg.inv(ref_proj.to(f32))
    rot = proj[:, :3, :3]
    trans = proj[:, :3, 3]
    gy, gx = torch.meshgrid(torch.arange(H, dtype=f32, device=dev),
                            torch.arange(W, dtype=f32, device=dev),
                            indexing="ij")
    xyz = torch.stack([gx.reshape(-1), gy.reshape(-1),
                       torch.ones(H * W, dtype=f32, device=dev)])
    rot_xyz = rot @ xyz                                   # (B, 3, HW)
    d = depth_values.to(f32).reshape(B, 1, D, -1)
    pts = rot_xyz[:, :, None, :] * d + trans[:, :, None, None]
    invalid = pts[:, 2] < 1e-6                            # (B, D, HW)
    z = torch.where(invalid, torch.ones_like(pts[:, 2]), pts[:, 2])
    px = torch.where(invalid, -99.0, pts[:, 0] / z)
    py = torch.where(invalid, -99.0, pts[:, 1] / z)
    idx, wx, wy = _cells(py.reshape(B, -1), px.reshape(B, -1), H, W)
    rows = _padded_quad(src_fea).index_select(0, idx).reshape(-1, 4, C)
    warped = (rows * _corner_weights(wx, wy)[..., None]).sum(dim=1)
    return warped.reshape(B, D, H, W, C).permute(0, 4, 1, 2, 3)


def depth_range_samples(cur_depth, ndepth: int, depth_interval_pixel, shape):
    """Per-pixel depth hypotheses (B, ndepth, H, W).

    Stage 1: cur_depth (B, D_full), the full range: ndepth steps over
    [min, max]. Later stages: cur_depth (B, H, W), the previous depth:
    ndepth steps over +-ndepth/2 intervals about it.
    """
    B, H, W = shape
    steps = torch.arange(ndepth, dtype=torch.float32, device=cur_depth.device)
    if cur_depth.dim() == 2:
        lo = cur_depth[:, 0]
        hi = cur_depth[:, -1]
        interval = (hi - lo) / (ndepth - 1)
        d = lo[:, None] + steps[None] * interval[:, None]
        return d[:, :, None, None].expand(B, ndepth, H, W)
    lo = cur_depth - ndepth / 2 * depth_interval_pixel
    hi = cur_depth + ndepth / 2 * depth_interval_pixel
    interval = (hi - lo) / (ndepth - 1)
    return lo[:, None] + steps[None, :, None, None] * interval[:, None]


def depth_wta(prob_volume, depth_values):
    """Winner-take-all depth (B, H, W): the hypothesis of the largest
    probability, the first of equal ones. prob_volume, depth_values:
    (B, D, H, W)."""
    idx = torch.argmax(prob_volume, dim=1, keepdim=True)
    return torch.gather(depth_values, 1, idx)[:, 0]
