"""The cascade's training losses (port of diner_tpu.mvs.losses).

Per stage a masked cross-entropy between the probability volume and the
ground truth's depth bin (weight 2.0), summed over the stages with the
`dlossw` weights; a smooth-L1 of the winner-take-all depth is reported
beside it. The BlendedMVS variant adds the end-point-error metrics. The
order of operations is the JAX package's: the GT bin is the first nearest
hypothesis, rounded after the mask multiplies it; -log(p + 1e-6); the
valid count carries + 1e-6.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch


def entropy_loss(prob_volume, depth_gt, mask, depth_values):
    """Masked cross-entropy against the one-hot GT bin.

    prob_volume (B, D, H, W), softmaxed; depth_gt and mask (B, H, W);
    depth_values (B, D, H, W). Returns (loss, WTA depth (B, H, W))."""
    mask = mask.float()
    valid = mask.sum(dim=(1, 2)) + 1e-6
    gt_idx = torch.argmin(torch.abs(depth_values - depth_gt[:, None]), dim=1)
    gt_idx = torch.round(mask * gt_idx).long()
    p_at_gt = torch.gather(prob_volume, 1, gt_idx[:, None])[:, 0]
    ce = -torch.log(p_at_gt + 1e-6)
    loss = ((ce * mask).sum(dim=(1, 2)) / valid).mean()
    wta_idx = torch.argmax(prob_volume, dim=1, keepdim=True)
    return loss, torch.gather(depth_values, 1, wta_idx)[:, 0]


def smooth_l1(pred, gt, mask):
    mask = mask.float()
    diff = torch.abs(pred - gt)
    val = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    return (val * mask).sum() / (mask.sum() + 1e-6)


def mvs_loss(outputs: Dict, depth_gt_ms: Dict, mask_ms: Dict,
             dlossw: Sequence[float] = (0.5, 1.0, 2.0),
             entropy_weight: float = 2.0):
    """The cascade's loss: sum over stages of dlossw[i] * entropy_weight *
    entropy_loss. outputs: TransMVSNet's; depth_gt_ms and mask_ms: {"stage1"
    ..: (B, h, w)}. Returns (total, aux): each stage's weighted entropy and
    depth smooth-L1, and depth_loss, the last stage's."""
    total = 0.0
    aux = {}
    depth_loss = 0.0
    for key in [k for k in outputs if k.startswith("stage")]:
        st = outputs[key]
        mask = mask_ms[key] > 0.5
        entro, wta = entropy_loss(st["prob_volume"], depth_gt_ms[key], mask,
                                  st["depth_values"])
        entro = entro * entropy_weight
        depth_loss = smooth_l1(wta, depth_gt_ms[key], mask)
        total = total + dlossw[int(key[len("stage"):]) - 1] * entro
        aux[f"{key}_entropy"] = entro
        aux[f"{key}_depth_l1"] = depth_loss
    aux["depth_loss"] = depth_loss
    return total, aux


def mvs_loss_focal(outputs: Dict, depth_gt_ms: Dict, mask_ms: Dict,
                   depth_interval, dlossw: Sequence[float] = (0.5, 1.0, 2.0)):
    """The BlendedMVS variant: mvs_loss, plus the last stage's end-point
    error in units of depth_interval * 192 / 128 (depth_interval (B, 1, 1))
    and the shares of masked pixels under 1 and 3 such units."""
    total, aux = mvs_loss(outputs, depth_gt_ms, mask_ms, dlossw)
    last = f"stage{sum(1 for k in outputs if k.startswith('stage'))}"
    mask = mask_ms[last] > 0.5
    err = torch.abs(depth_gt_ms[last] - outputs[last]["depth"])
    scaled = err / (depth_interval * 192.0 / 128.0)
    denom = mask.sum() + 1e-6
    zero = torch.zeros_like(scaled)
    aux["epe"] = torch.where(mask, scaled, zero).sum() / denom
    aux["less1"] = torch.where(mask, (scaled < 1.0).float(), zero).sum() / denom
    aux["less3"] = torch.where(mask, (scaled < 3.0).float(), zero).sum() / denom
    return total, aux


def aux_mask_stage(name: str, stages: Sequence[str]) -> Optional[str]:
    """The stage over whose masked pixels an aux value of `mvs_loss` or
    `mvs_loss_focal` is a mean, taken over the whole batch (the depth
    smooth-L1s, the end-point error and its shares), or None for the
    entropies, which are means over the samples. `stages`: the mask
    pyramid's keys."""
    if name.endswith("_depth_l1"):
        return name[:-len("_depth_l1")]
    if name in ("depth_loss", "epe", "less1", "less3"):
        return sorted(stages)[-1]
    return None
