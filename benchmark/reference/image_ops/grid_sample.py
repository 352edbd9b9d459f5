"""Pixel-aligned sampling of NHWC maps at normalized coordinates (port of
diner_tpu.image_ops.grid_sample).

Semantics of torch's grid_sample with align_corners=False: uv in [-1, 1],
where -1/+1 are the outer edges of the border pixels. Maps stay NHWC so that
each lookup reads one contiguous channel row. The "exponential" padding
(nearest mode only) extrapolates the border value, doubling it every
`pad_double_width` px outside the image and giving 0 beyond `pad_size` px:
the depth-std lookup's rule (src/util/torch_helpers.py:99-159 of the
reference).
"""

from __future__ import annotations

import math

import torch


def _unnormalize(coord, size):
    """[-1, 1] -> pixel coordinate (centers at 0..size-1)."""
    return (coord + 1.0) * 0.5 * size - 0.5


def _gather_rows(flat, idx):
    """flat (B, R, C); idx (B, N) int in [0, R). -> (B, N, C)."""
    B, N = idx.shape
    return torch.gather(flat, 1, idx.long()[..., None].expand(B, N,
                                                              flat.shape[-1]))


def grid_sample(img, uv, mode: str = "bilinear",
                padding_mode: str = "border", pad_double_width: float = 20.0,
                pad_size: int = 40):
    """Sample img (..., H, W, C) at uv (..., N, 2) (x, y order, same leading
    dims). Modes: bilinear or nearest with "border" or "zeros" padding
    (outside the image reads 0), and nearest with "exponential" padding
    (pad_double_width, pad_size). Returns (..., N, C)."""
    batch_shape = img.shape[:-3]
    H, W, C = img.shape[-3:]
    N = uv.shape[-2]
    flat = img.reshape(-1, H * W, C)
    uvs = uv.reshape(-1, N, 2)
    if padding_mode == "exponential":
        if mode != "nearest":
            raise ValueError("exponential padding is defined for nearest "
                             "mode only")
        out = _sample_exponential_nearest(flat, uvs, H, W, pad_double_width,
                                          pad_size)
        return out.reshape(*batch_shape, N, C)
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    zeros = padding_mode == "zeros"
    ix = _unnormalize(uvs[..., 0], W)
    iy = _unnormalize(uvs[..., 1], H)

    if mode == "nearest":
        jx = torch.round(ix).to(torch.int32)
        jy = torch.round(iy).to(torch.int32)
        out = _gather_rows(flat, jy.clamp(0, H - 1) * W + jx.clamp(0, W - 1))
        if zeros:
            ok = (jx >= 0) & (jx < W) & (jy >= 0) & (jy < H)
            out = out * ok[..., None].to(out.dtype)
        return out.reshape(*batch_shape, N, C)
    if mode != "bilinear":
        raise ValueError(f"unknown mode {mode!r}")

    if not zeros:
        ix = ix.clamp(0.0, W - 1.0)
        iy = iy.clamp(0.0, H - 1.0)
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    wx = ix - x0
    wy = iy - y0
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)

    def corner(yi, xi, w):
        vals = _gather_rows(flat, yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1))
        if zeros:
            ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            w = w * ok.to(w.dtype)
        return vals * w[..., None]

    out = (corner(y0i, x0i, (1 - wx) * (1 - wy))
           + corner(y0i, x0i + 1, wx * (1 - wy))
           + corner(y0i + 1, x0i, (1 - wx) * wy)
           + corner(y0i + 1, x0i + 1, wx * wy))
    return out.reshape(*batch_shape, N, C)


def _sample_exponential_nearest(flat, uvs, H: int, W: int,
                                double_width: float, pad: int):
    """Nearest sampling of the exponentially padded image, computed without
    padding it: the padded pixel at Chebyshev distance d (0 next to the
    image) holds the border value times 2^(d / double_width); beyond `pad`
    px it is 0. flat (B, H*W, C), uvs (B, N, 2) -> (B, N, C)."""
    Hp, Wp = H + 2 * pad, W + 2 * pad
    # uv rescaled to the padded image, then unnormalized on it
    jxp = torch.round(_unnormalize(uvs[..., 0] * (W / Wp), Wp)).to(
        torch.int32)
    jyp = torch.round(_unnormalize(uvs[..., 1] * (H / Hp), Hp)).to(
        torch.int32)
    valid = (jxp >= 0) & (jxp < Wp) & (jyp >= 0) & (jyp < Hp)
    jx, jy = jxp - pad, jyp - pad
    dx = torch.maximum(-jx - 1, jx - W).clamp(min=0)
    dy = torch.maximum(-jy - 1, jy - H).clamp(min=0)
    d = torch.maximum(dx, dy).to(flat.dtype)
    base = _gather_rows(flat, jy.clamp(0, H - 1) * W + jx.clamp(0, W - 1))
    scale = torch.exp2(d / double_width) * valid.to(flat.dtype)
    return base * scale[..., None]


def exponential_pad(img, padding: int, double_width: float):
    """The exponential padding materialized: img (B, H, W, C) edge-padded by
    `padding` px, the border values times 2^(Chebyshev distance to the image
    / double_width)."""
    B, H, W, C = img.shape
    yy = torch.arange(H + 2 * padding, device=img.device)
    xx = torch.arange(W + 2 * padding, device=img.device)
    base = img[:, (yy - padding).clamp(0, H - 1)][:, :,
                                                  (xx - padding).clamp(0, W - 1)]
    dy = torch.maximum(padding - 1 - yy, yy - (H + padding)).clamp(min=0)
    dx = torch.maximum(padding - 1 - xx, xx - (W + padding)).clamp(min=0)
    d = torch.maximum(dy[:, None], dx[None, :]).to(img.dtype)
    return base * torch.exp(d / double_width * math.log(2.0))[None, :, :,
                                                                None]


def pack_quad(img):
    """(..., H, W, C) -> (..., H, W, 4C): each pixel packed with its right,
    down and diagonal neighbours (edge-clamped), slots [self, right, down,
    diag], so a bilinear/border fetch is one row gather."""
    right = torch.cat([img[..., :, 1:, :], img[..., :, -1:, :]], dim=-2)
    down = torch.cat([img[..., 1:, :, :], img[..., -1:, :, :]], dim=-3)
    diag = torch.cat([down[..., :, 1:, :], down[..., :, -1:, :]], dim=-2)
    return torch.cat([img, right, down, diag], dim=-1)


def quad_cells(H: int, W: int, uv):
    """Texel cells of normalized uv (..., 2) for a quad-packed H x W image:
    (idx int32 flat row of the cell's top-left corner, wx, wy in-cell
    bilinear weights)."""
    ix = _unnormalize(uv[..., 0], W).clamp(0.0, W - 1.0)
    iy = _unnormalize(uv[..., 1], H).clamp(0.0, H - 1.0)
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    idx = (y0.to(torch.int32).clamp(0, H - 1) * W
           + x0.to(torch.int32).clamp(0, W - 1))
    return idx, ix - x0, iy - y0


def quad_blend(rows, wx, wy):
    """Bilinear combine of quad rows (..., 4C) with weights wx/wy (...).
    Integer rows (int8 latents) promote to the weights' float type."""
    C = rows.shape[-1] // 4
    wx = wx[..., None]
    wy = wy[..., None]
    p00 = rows[..., 0 * C:1 * C]
    p01 = rows[..., 1 * C:2 * C]
    p10 = rows[..., 2 * C:3 * C]
    p11 = rows[..., 3 * C:4 * C]
    return (p00 * (1 - wx) * (1 - wy) + p01 * wx * (1 - wy)
            + p10 * (1 - wx) * wy + p11 * wx * wy)


def grid_sample_quad(img_quad, uv, dtype=None):
    """Bilinear/border sampling of a pack_quad image (..., H, W, 4C) at uv
    (..., N, 2). Equals grid_sample(img, uv, "bilinear", "border"). dtype:
    the rows and weights are blended in that type (default: the weights'
    float32)."""
    batch_shape = img_quad.shape[:-3]
    H, W, C4 = img_quad.shape[-3:]
    N = uv.shape[-2]
    flat = img_quad.reshape(-1, H * W, C4)
    idx, wx, wy = quad_cells(H, W, uv.reshape(-1, N, 2))
    rows = _gather_rows(flat, idx)
    if dtype is not None:
        rows, wx, wy = rows.to(dtype), wx.to(dtype), wy.to(dtype)
    out = quad_blend(rows, wx, wy)
    return out.reshape(*batch_shape, N, C4 // 4)
