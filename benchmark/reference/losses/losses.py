"""Training losses: MSE, L1, antibias and VGG-perceptual (port of
diner_tpu.losses.losses).

The VGG loss is the reference VGGLoss (src/losses/vggloss.py:48-69 in
malteprinzler/diner): L1 between the tower's four slices of the
ImageNet-normalized images, weighted 1/16, 1/8, 1/4 and 1, with the
target's features detached. The antibias loss is L1 between 2^n-fold
average-pooled images (src/losses/antibiasloss.py:4-14). Images are NHWC.
"""

from __future__ import annotations

import torch

from reference.core.types import IMAGENET_MEAN, IMAGENET_STD
from reference.image_ops.resize import avg_pool2d

VGG_SLICE_WEIGHTS = (1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


def mse_loss(pred, target):
    return ((pred - target) ** 2).mean()


def l1_loss(pred, target):
    return (pred - target).abs().mean()


def antibias_loss(pred_img, target_img, n_downsampling: int = 3):
    """L1 between 2^n-fold average-pooled images (..., H, W, C)."""
    k = 2 ** n_downsampling
    return l1_loss(avg_pool2d(pred_img, k), avg_pool2d(target_img, k))


def vgg_perceptual_loss(vgg, pred_img, target_img):
    """Weighted L1 over the VGG slices; vgg maps NHWC images in ImageNet
    normalization to a list of 4 feature maps (a Vgg19Features)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=pred_img.dtype,
                        device=pred_img.device)
    std = torch.tensor(IMAGENET_STD, dtype=pred_img.dtype,
                       device=pred_img.device)
    fx = vgg((pred_img - mean) / std)
    fy = vgg((target_img - mean) / std)
    loss = 0.0
    for w, a, b in zip(VGG_SLICE_WEIGHTS, fx, fy):
        loss = loss + w * l1_loss(a, b.detach())
    return loss
