"""VGG19 feature tower of the perceptual loss (port of diner_tpu.nn.vgg).

Slices end after relu1_1, relu2_1, relu3_1 and relu4_1, torchvision's
`features[0:2]`, `[2:7]`, `[7:12]` and `[12:21]` (src/losses/vggloss.py in
malteprinzler/diner). Convolutions 3x3 with padding 1 and bias, max pools
2x2 stride 2. Input and outputs keep the JAX package's NHWC layout; the
tower runs NCHW inside. Its parameters are frozen (requires_grad False):
the loss trains the NeRF, not the tower. Random weights (flax's default
`lecun_normal`, as the JAX tower draws them) serve wiring only; real ones come
from a reference checkpoint (models/lightning.py) or from flax params
(models/from_jax.py).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.nn.init import lecun_normal_

# (name, in channels, out channels) in torchvision's order; a max pool comes
# before conv2_1, conv3_1 and conv4_1
CONVS = (("conv1_1", 3, 64), ("conv1_2", 64, 64), ("conv2_1", 64, 128),
         ("conv2_2", 128, 128), ("conv3_1", 128, 256), ("conv3_2", 256, 256),
         ("conv3_3", 256, 256), ("conv3_4", 256, 256), ("conv4_1", 256, 512))
SLICE_ENDS = ("conv1_1", "conv2_1", "conv3_1", "conv4_1")
POOL_BEFORE = ("conv2_1", "conv3_1", "conv4_1")
# torchvision `features` index of each conv, and the slice that holds it
TORCHVISION_INDEX = {"conv1_1": 0, "conv1_2": 2, "conv2_1": 5, "conv2_2": 7,
                     "conv3_1": 10, "conv3_2": 12, "conv3_3": 14,
                     "conv3_4": 16, "conv4_1": 19}


def slice_of(name: str) -> int:
    """The 1-based slice of the reference VGGLoss that holds conv `name`."""
    return 1 + sum(TORCHVISION_INDEX[name] > TORCHVISION_INDEX[end]
                   for end in SLICE_ENDS)


class Vgg19Features(nn.Module):
    def __init__(self, n_slices: int = 4):
        super().__init__()
        self.n_slices = n_slices
        for name, c_in, c_out in CONVS:
            conv = nn.Conv2d(c_in, c_out, 3, padding=1)
            lecun_normal_(conv.weight, 9 * c_in)
            nn.init.zeros_(conv.bias)
            self.add_module(name, conv)
        self.requires_grad_(False)

    def forward(self, x) -> List[torch.Tensor]:
        """x (N, H, W, 3) -> the activations after relu1_1 .. relu4_1 (the
        first n_slices of them), each (N, H_i, W_i, C_i)."""
        y = x.permute(0, 3, 1, 2)
        outs = []
        for name, _, _ in CONVS:
            if name in POOL_BEFORE:
                y = F.max_pool2d(y, 2, stride=2)
            y = F.relu(getattr(self, name)(y))
            if name in SLICE_ENDS:
                outs.append(y.permute(0, 2, 3, 1))
                if len(outs) == self.n_slices:
                    break
        return outs
