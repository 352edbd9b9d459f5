"""Foreground-aware downsampling (port of diner_tpu.image_ops.downsample).

Behavioral reference: src/util/torch_helpers.py:162-212 (masked_downsampling)
in malteprinzler/diner: integer-factor average pooling that does not wash
background colour into the foreground; the mask decides fg by nearest
sampling. NHWC tensors on the input's device.
"""

from __future__ import annotations

import torch

from diner_tpu_torch.image_ops.grid_sample import grid_sample
from diner_tpu_torch.image_ops.resize import avg_pool2d


def _nearest_downsample(x, factor: int):
    """Nearest sampling at output-pixel centres (the reference's grid)."""
    H, W = x.shape[-3], x.shape[-2]
    h, w = H // factor, W // factor
    ys = (torch.arange(factor / 2.0, H, factor, dtype=torch.float32,
                       device=x.device) / H) * 2 - 1
    xs = (torch.arange(factor / 2.0, W, factor, dtype=torch.float32,
                       device=x.device) / W) * 2 - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    uv = torch.stack([gx, gy], dim=-1).reshape(-1, 2)
    uv = uv.expand(*x.shape[:-3], h * w, 2)
    out = grid_sample(x, uv, mode="nearest", padding_mode="border")
    return out.reshape(*x.shape[:-3], h, w, x.shape[-1])


def masked_downsample(x, mask, factor: int, mode: str = "average",
                      bg_color: float = 0.0):
    """Downsample (..., H, W, C) by an integer `factor` without fg/bg colour
    bleed.

    mask: (..., H, W, 1) with 1 = fg. "average": fg output pixels average
    only fg input pixels; pixels whose nearest-sampled mask is background
    get `bg_color`. "nearest": plain nearest sampling.

    Like the reference (torch_helpers.py:188-194), the numerator keeps only
    pixels with mask >= 1 while the denominator sums the RAW mask, so values
    under partial alpha (0 < mask < 1) are darkened in proportion. Feed a
    binary mask when that bias is unwanted.
    """
    if x.shape[-3] % factor or x.shape[-2] % factor:
        raise ValueError("spatial dims must be divisible by factor")
    if mode == "nearest":
        return _nearest_downsample(x, factor)
    if mode != "average":
        raise ValueError(f"unknown mode {mode!r}")

    fg = (mask >= 1).to(x.dtype)
    x_sum = avg_pool2d(x * fg, factor) * (factor * factor)
    m_sum = avg_pool2d(mask.to(x.dtype), factor) * (factor * factor)
    m_nearest = _nearest_downsample(mask.to(x.dtype), factor)

    avg = x_sum / torch.where(m_sum == 0, torch.ones_like(m_sum), m_sum)
    return torch.where(m_nearest > 0, avg,
                       torch.as_tensor(bg_color, dtype=avg.dtype,
                                       device=avg.device))
