"""K1's plain PyTorch version (frozen copy of the port's
`likelihood_from_anchors_plain`): the reference never launches a kernel."""

from __future__ import annotations

import math

import torch


def likelihood_from_anchors_plain(a, vals, z_cam, half_step,
                                  depth_diff_max: float,
                                  return_selected: bool = False):
    """The same function in plain PyTorch: torch.gather and the same
    arithmetic, on any device."""
    G, NC = a.shape
    sel = torch.gather(vals, 2, a.long()[:, None, :].expand(G, 3, NC))
    d, std, cos = sel.unbind(1)
    valid = (cos <= 0) & ((d - z_cam).abs() < depth_diff_max) & (std != 0)
    sstd = torch.where(std == 0, torch.ones_like(std), std) * math.sqrt(2.0)
    hi = torch.erf((z_cam + half_step - d) / sstd)
    lo = torch.erf((z_cam - half_step - d) / sstd)
    p = torch.where(valid, 0.5 * (hi - lo).abs(), torch.zeros_like(hi))
    return (p, sel) if return_selected else p


likelihood_from_anchors = likelihood_from_anchors_plain
