"""K2's plain PyTorch version (frozen copy of the port's
`remap_anchors_plain`)."""

from __future__ import annotations

import torch


def remap_anchors_plain(a, vals):
    """The same function in plain PyTorch (torch.gather), on any device."""
    G, NS = a.shape
    C = vals.shape[1]
    return torch.gather(vals, 2, a.long()[:, None, :].expand(G, C, NS))


remap_anchors = remap_anchors_plain
