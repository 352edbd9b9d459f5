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


def _blend_in_order(rows, wx, wy):
    p00, p01, p10, p11 = rows.unbind(1)
    return (p00 * (1 - wx) * (1 - wy) + p01 * wx * (1 - wy)
            + p10 * (1 - wx) * wy + p11 * wx * wy)


class _Blend(torch.autograd.Function):
    """Quad rows (M, 4, C) and in-cell weights (M, 1) -> the bilinear
    samples (M, C), in the JAX package's order of operations, so that a
    bfloat16 call rounds each product where it does. The backward pass
    works from the rows and weights alone, so no product is kept for it."""

    @staticmethod
    def forward(ctx, rows, wx, wy):
        ctx.save_for_backward(rows, wx, wy)
        return _blend_in_order(rows, wx, wy)

    @staticmethod
    def backward(ctx, g):
        rows, wx, wy = ctx.saved_tensors
        need_rows, need_wx, need_wy = ctx.needs_input_grad
        g_rows = g_wx = g_wy = None
        if need_rows:
            cw = _corner_weights(wx[:, 0], wy[:, 0])
            g_rows = g[:, None] * cw[..., None]
        p00, p01, p10, p11 = rows.unbind(1)
        if need_wx:
            g_wx = (g * ((p01 - p00) * (1 - wy) + (p11 - p10) * wy)).sum(
                1, keepdim=True)
        if need_wy:
            g_wy = (g * ((p10 - p00) * (1 - wx) + (p11 - p01) * wx)).sum(
                1, keepdim=True)
        return g_rows, g_wx, g_wy


_blend = _Blend.apply


def deform_conv2d(x, offset, mask, weight, bias=None):
    """Modulated deformable convolution (DCNv2): stride 1, "same" padding,
    square kernel, zeros outside the image.

    x: (N, C, H, W); offset: (N, 2*K*K, H, W), (dy, dx) of tap k at
    channels 2k and 2k+1 (taps row-major); mask: (N, K*K, H, W); weight:
    (O, C, K, K); bias: (O,). Returns (N, O, H, W) in x's dtype.

    The taps are gathered one at a time and each one's product with its
    weight slice is added to the output, so that only one tap's rows are
    live at once. A tap's four corners, scaled by their bilinear weights
    and the mask, go through one matmul with the weight slice repeated four
    times, which sums them. The sample positions stay float32 in a
    bfloat16 call, whose corners are blended in the JAX package's order
    (`_blend`), each product rounded to bfloat16, scaled by the mask and
    multiplied by the weight slice in float32, as its einsum does; the taps
    accumulate in float32.
    """
    N, C, H, W = x.shape
    O, _, K, _ = weight.shape
    pad = (K - 1) // 2
    dev = x.device
    dt = x.dtype
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    gy = gy.reshape(1, H * W)
    gx = gx.reshape(1, H * W)
    off = offset.float().reshape(N, K * K, 2, H * W)
    m = mask.to(dt).reshape(N, K * K, H * W)
    xq = _padded_quad(x)
    w = weight.to(dt).reshape(O, C, K * K)
    out = torch.zeros(N * H * W, O, dtype=torch.float32, device=dev)
    for t in range(K * K):
        ky, kx = t // K - pad, t % K - pad
        idx, wx, wy = _cells(gy + ky + off[:, t, 0], gx + kx + off[:, t, 1],
                             H, W)
        wx, wy, m_t = wx.to(dt), wy.to(dt), m[:, t].reshape(-1, 1)
        rows = xq.index_select(0, idx).reshape(-1, 4, C)
        if dt == torch.bfloat16:
            s = _blend(rows, wx[:, None], wy[:, None]) * m_t
            out = out + s.float() @ w[:, :, t].t().float()
        else:
            rows = rows * (_corner_weights(wx, wy) * m_t)[..., None]
            out = out + (rows.reshape(-1, 4 * C)
                         @ w[:, :, t].t().repeat(4, 1)).float()
    out = out.reshape(N, H, W, O).permute(0, 3, 1, 2).to(dt)
    if bias is not None:
        out = out + bias.to(dt)[:, None, None]
    return out


def deform_conv2d_window(x, offset, mask, weight, bias=None,
                         margin: int = 2):
    """Gather-free modulated deformable convolution: a data-weighted
    stencil over statically shifted maps. Same arguments as
    `deform_conv2d`; returns (N, O, H, W) in x's dtype.

    Each tap's displacement k + offset is clipped to [-R, R - 1e-3] about
    its pixel (R = margin), and its bilinear sample is rebuilt from the
    (2R + 1)^2 static shifts of the zero-padded map. The mask and the
    kernel commute with the blend, so Z_t = x @ W_t is computed once per
    tap and the shifts weight Z_t, accumulated in float32:

        out[p] = sum_t sum_s m_t(p) w_{t,s}(p) Z_t[p + s].

    It equals `deform_conv2d` while every |k + offset| < R - 1e-3 (for a
    3x3 kernel, |offset| < 1 px); a tap beyond the window is clamped to
    its edge, and its offset gets no gradient there.
    """
    N, C, H, W = x.shape
    O, _, K, _ = weight.shape
    taps = K * K
    pad = (K - 1) // 2
    R = int(margin)
    dt = x.dtype
    dev = x.device
    k = torch.arange(taps, device=dev)
    ky = (k // K - pad).float().reshape(1, taps, 1, 1)
    kx = (k % K - pad).float().reshape(1, taps, 1, 1)
    off = offset.float().reshape(N, taps, 2, H, W)
    dy = (ky + off[:, :, 0]).clamp(-float(R), R - 1e-3)
    dx = (kx + off[:, :, 1]).clamp(-float(R), R - 1e-3)
    c0y = torch.floor(dy)
    c0x = torch.floor(dx)
    fy = (dy - c0y).to(dt)
    fx = (dx - c0x).to(dt)
    m = mask.to(dt)
    w = weight.to(dt).reshape(O, C, taps)
    out = torch.zeros(N, O, H, W, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    shifts = range(-R, R + 1)

    def axis_weights(c0, f):
        # the bilinear weight of each shift along one axis
        g = 1 - f
        return [torch.where(c0 == s, g, zero) + torch.where(c0 == s - 1, f,
                                                             zero)
                for s in shifts]

    for t in range(taps):
        z = torch.einsum("nchw,oc->nohw", x, w[:, :, t])
        zp = F.pad(z, (R, R + 1, R, R + 1))
        wy = axis_weights(c0y[:, t], fy[:, t])
        wx = axis_weights(c0x[:, t], fx[:, t])
        m_t = m[:, t]
        for i, a in enumerate(shifts):
            for j, b in enumerate(shifts):
                # the JAX package's order of products (wy * wx * m), where
                # a bfloat16 call rounds; float32 accumulates in one pass
                wgt = (wy[i] * wx[j] * m_t)[:, None]
                zs = zp[:, :, R + a:R + a + H, R + b:R + b + W]
                if dt == torch.float32:
                    out.addcmul_(wgt, zs)
                else:
                    out += (wgt * zs).float()
    out = out.to(dt)
    if bias is not None:
        out = out + bias.to(dt)[:, None, None]
    return out


def homo_warping(src_fea, src_proj, ref_proj, depth_values):
    """Plane-sweep warp of source features into the reference frustum.

    src_fea: (B, C, H, W); src_proj, ref_proj: (B, 4, 4), intrinsics
    premultiplied into [R|t]; depth_values: (B, D, H, W) or (B, D).
    Returns (B, C, D, H, W) in src_fea's dtype (the geometry in
    float32; a bfloat16 call blends as `deform_conv2d` does). Samples with
    z < 1e-6 read zeros.
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
    dt = src_fea.dtype
    wx, wy = wx.to(dt), wy.to(dt)
    if dt == torch.bfloat16:
        warped = _blend(rows, wx[:, None], wy[:, None])
    else:
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
