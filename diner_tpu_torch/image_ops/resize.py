"""Separable bilinear resize with align_corners=True (port of
diner_tpu.image_ops.resize.resize_bilinear_align_corners).

The source grid is computed in the input's dtype, as the JAX package does:
under bf16 the grid itself rounds, which F.interpolate would not reproduce.
"""

from __future__ import annotations

import torch


def _axis_resize(x, size_in: int, size_out: int, axis: int):
    if size_in == size_out:
        return x
    dt, dev = x.dtype, x.device
    if size_out == 1:
        src = torch.zeros(1, dtype=dt, device=dev)
    else:
        # scale as a tensor of x's dtype: a Python scalar would multiply in
        # f32 and skip the rounding of the scale to x's dtype
        scale = torch.tensor((size_in - 1) / (size_out - 1), dtype=dt,
                             device=dev)
        src = torch.arange(size_out, device=dev).to(dt) * scale
    lo = torch.floor(src).to(torch.int64).clamp(0, size_in - 1)
    hi = (lo + 1).clamp(0, size_in - 1)
    w = src - lo.to(dt)
    shape = [1] * x.ndim
    shape[axis] = size_out
    w = w.reshape(shape)
    return (x.index_select(axis, lo) * (1 - w)
            + x.index_select(axis, hi) * w)


def resize_bilinear_align_corners(img, out_hw):
    """img (..., H, W, C) -> (..., H_out, W_out, C)."""
    H_out, W_out = out_hw
    H, W = img.shape[-3], img.shape[-2]
    out = _axis_resize(img, H, H_out, img.ndim - 3)
    return _axis_resize(out, W, W_out, img.ndim - 2)
