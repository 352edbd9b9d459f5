"""DINER: PixelNeRF + the depth-guided renderer, with its training losses
(port of diner_tpu.models.diner).

losses(batch, train): encode -> rays of the whole target image -> pixel or
patch selection -> depth-guided render (sampler under no_grad, gradients
through the field and K4) -> MSE (+ VGG + antibias on patches).
render_batch(batch): encode the source views once, then render the full
target images in ray chunks.

Ray selection follows the reference (src/models/diner.py:229-258 in
malteprinzler/diner): random pixels when neither patch loss is on, else one
square patch of vgg_spatch^2 pixels per sample, its centre drawn from the
target alpha inside a border of (vgg_spatch + 1) // 2 px (optionally
eroded by erode_fg_mask px first).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.core.types import RenderConfig
from reference.geometry import gen_rays
from reference.losses import (antibias_loss, mse_loss,
                                    vgg_perceptual_loss)
from reference.models.pixelnerf import PixelNeRF
from reference.nn.vgg import Vgg19Features
from reference.renderer import render_rays

SOURCE_KEYS = ("src_rgbs", "src_depths", "src_depth_stds", "src_extrinsics",
               "src_intrinsics")


def to_tensors(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The array entries of a sample batch as float32 tensors on device."""
    return {k: torch.as_tensor(v).to(device=device, dtype=torch.float32)
            for k, v in batch.items()
            if isinstance(v, (np.ndarray, torch.Tensor))}


class DINER(nn.Module):
    """Arguments as diner_tpu.models.DINER's fields. The VGG tower exists
    when w_vgg != 0, frozen."""

    def __init__(self, nerf: PixelNeRF,
                 render_cfg: RenderConfig = RenderConfig(),
                 znear: float = 0.5, zfar: float = 2.5,
                 ray_batch_size: int = 128, w_vgg: float = 0.0,
                 vgg_spatch: int = 64, w_antibias: float = 0.0,
                 antibias_downsampling: int = 3, erode_fg_mask: int = 0):
        super().__init__()
        self.nerf = nerf
        self.render_cfg = render_cfg
        self.znear, self.zfar = znear, zfar
        self.ray_batch_size = ray_batch_size
        self.w_vgg, self.vgg_spatch = w_vgg, vgg_spatch
        self.w_antibias = w_antibias
        self.antibias_downsampling = antibias_downsampling
        self.erode_fg_mask = erode_fg_mask
        self.vgg = Vgg19Features() if w_vgg != 0 else None

    @property
    def _patch_losses(self) -> bool:
        # patch-shaped rays for the VGG and the antibias loss (the
        # reference keys this on w_vgg alone)
        return self.w_vgg != 0 or self.w_antibias != 0

    @property
    def n_rays(self) -> int:
        return (self.vgg_spatch ** 2 if self._patch_losses
                else self.ray_batch_size)

    def encode_batch(self, batch, train: bool = False):
        return self.nerf.encode(*(batch[k] for k in SOURCE_KEYS),
                                train=train)

    def _select_pixels(self, batch, SB: int, H: int, W: int, generator=None):
        """(SB, n_rays) int64 flat pixel indices into the target image. A
        sample with no foreground inside the border draws its patch centre
        uniformly inside the border (the JAX package's categorical over an
        all -inf row has no defined draw)."""
        dev = batch["target_rgb"].device
        if not self._patch_losses:
            return torch.randint(0, H * W, (SB, self.n_rays), device=dev,
                                 generator=generator)
        s = self.vgg_spatch
        pad = (s + 1) // 2
        fg = batch["target_alpha"][..., 0]                 # (SB, H, W)
        if self.erode_fg_mask > 0:
            # min filter as a negated max pool, window 2r + 1, stride 1
            r = self.erode_fg_mask
            fg = -F.max_pool2d(-fg[:, None], 2 * r + 1, stride=1,
                               padding=r)[:, 0]
        border = torch.zeros((H, W), dtype=torch.bool, device=dev)
        border[pad:H - pad, pad:W - pad] = True
        weights = torch.where(border & (fg > 0), fg, 0.0).reshape(SB, H * W)
        empty = weights.sum(-1, keepdim=True) == 0
        weights = torch.where(empty, border.reshape(1, -1).float(), weights)
        centers = torch.multinomial(weights, 1, generator=generator)[:, 0]
        cx, cy = centers % W, centers // W
        oy, ox = torch.meshgrid(torch.arange(s, device=dev),
                                torch.arange(s, device=dev), indexing="ij")
        px = cx[:, None, None] + (ox - pad)
        py = cy[:, None, None] + (oy - pad)
        return (px + py * W).reshape(SB, s * s)

    def losses(self, batch: Dict, train: bool = False, pix=None, noise=None,
               generator=None) -> Dict[str, torch.Tensor]:
        """The loss dict {"rgb_fine", ["vgg_fine"], ["antibias"], "total"}
        of a batch of tensors on one device. pix (SB, n_rays) and noise (the
        sampler's (u_strat, g, u_fill)) replace the draws, which otherwise
        come from `generator`."""
        SB, H, W, _ = batch["target_rgb"].shape
        dev = batch["target_rgb"].device
        enc = self.encode_batch(batch, train=train)
        rays = gen_rays(batch["target_extrinsics"],
                        batch["target_intrinsics"], W, H,
                        torch.full((SB,), self.znear, device=dev),
                        torch.full((SB,), self.zfar, device=dev)
                        ).reshape(SB, H * W, 8)
        if pix is None:
            pix = self._select_pixels(batch, SB, H, W, generator)
        pix = torch.as_tensor(pix, device=dev).long()
        rays = torch.gather(rays, 1, pix[..., None].expand(-1, -1, 8))
        gt = torch.gather(batch["target_rgb"].reshape(SB, H * W, 3), 1,
                          pix[..., None].expand(-1, -1, 3))
        pred = render_rays(lambda p, d, aux: self.nerf.field(enc, p, d, aux),
                           rays, enc, self.render_cfg, noise,
                           generator)["rgb"]

        loss_fine = mse_loss(pred, gt)
        total = loss_fine
        out = {"rgb_fine": loss_fine}
        if self._patch_losses:
            s = self.vgg_spatch
            pred_img = pred.reshape(SB, s, s, 3)
            gt_img = gt.reshape(SB, s, s, 3)
            if self.w_vgg > 0:
                out["vgg_fine"] = vgg_perceptual_loss(self.vgg, pred_img,
                                                      gt_img)
                total = total + self.w_vgg * out["vgg_fine"]
            if self.w_antibias > 0:
                out["antibias"] = antibias_loss(pred_img, gt_img,
                                                self.antibias_downsampling)
                total = total + self.w_antibias * out["antibias"]
        out["total"] = total
        return out
