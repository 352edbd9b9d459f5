"""Pixel-aligned sampling of NHWC maps at normalized coordinates (port of
diner_tpu.image_ops.grid_sample).

Semantics of torch's grid_sample with align_corners=False: uv in [-1, 1],
where -1/+1 are the outer edges of the border pixels. Maps stay NHWC so that
each lookup reads one contiguous channel row.
"""

from __future__ import annotations

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
                padding_mode: str = "border"):
    """Sample img (..., H, W, C) at uv (..., N, 2) (x, y order, same leading
    dims). Modes: bilinear/border and nearest/border (the two the render path
    uses). Returns (..., N, C)."""
    batch_shape = img.shape[:-3]
    H, W, C = img.shape[-3:]
    N = uv.shape[-2]
    flat = img.reshape(-1, H * W, C)
    uvs = uv.reshape(-1, N, 2)
    if padding_mode != "border":
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    ix = _unnormalize(uvs[..., 0], W)
    iy = _unnormalize(uvs[..., 1], H)

    if mode == "nearest":
        jx = torch.round(ix).to(torch.int32).clamp(0, W - 1)
        jy = torch.round(iy).to(torch.int32).clamp(0, H - 1)
        out = _gather_rows(flat, jy * W + jx)
        return out.reshape(*batch_shape, N, C)
    if mode != "bilinear":
        raise ValueError(f"unknown mode {mode!r}")

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
        return vals * w[..., None]

    out = (corner(y0i, x0i, (1 - wx) * (1 - wy))
           + corner(y0i, x0i + 1, wx * (1 - wy))
           + corner(y0i + 1, x0i, (1 - wx) * wy)
           + corner(y0i + 1, x0i + 1, wx * wy))
    return out.reshape(*batch_shape, N, C)


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


def grid_sample_quad(img_quad, uv):
    """Bilinear/border sampling of a pack_quad image (..., H, W, 4C) at uv
    (..., N, 2). Equals grid_sample(img, uv, "bilinear", "border")."""
    batch_shape = img_quad.shape[:-3]
    H, W, C4 = img_quad.shape[-3:]
    N = uv.shape[-2]
    flat = img_quad.reshape(-1, H * W, C4)
    idx, wx, wy = quad_cells(H, W, uv.reshape(-1, N, 2))
    out = quad_blend(_gather_rows(flat, idx), wx, wy)
    return out.reshape(*batch_shape, N, C4 // 4)
