"""Small tensor statistics (port of diner_tpu.utils.stats)."""

from __future__ import annotations

import torch


def weighted_mean_and_std(x, weights, axis: int = -1, keepdims: bool = False):
    """Weighted mean and (biased) weighted std along `axis`."""
    wsum = weights.sum(dim=axis, keepdim=True)
    wn = weights / torch.where(wsum == 0, torch.ones_like(wsum), wsum)
    mean = (x * wn).sum(dim=axis, keepdim=True)
    std = torch.sqrt(((x - mean) ** 2 * wn).sum(dim=axis, keepdim=True))
    if not keepdims:
        mean = mean.squeeze(axis)
        std = std.squeeze(axis)
    return mean, std
