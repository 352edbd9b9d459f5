"""Weight initializers that the flax modules of the JAX package use and
torch has no exact counterpart of."""

from __future__ import annotations

import math

import torch
from torch import nn


def lecun_normal_(w, fan_in: int):
    """flax's default kernel init: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std)
