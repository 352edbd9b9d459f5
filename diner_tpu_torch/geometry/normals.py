"""Depth map -> camera-space normal map by central differences, with the
invalid-neighbour repair of diner_tpu.geometry.normals.depth2normal.

Normals whose neighbourhood holds an invalid (depth == 0) pixel borrow the
normal one step away from the invalid side; invalid pixels get zero normals.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from diner_tpu_torch.geometry.rays import _pixel_grid


def depth2normal(dmap, K):
    """dmap (B, H, W, 1) metric depth, 0 = invalid; K (B, 3, 3).
    Returns (B, H, W, 3) unit normals."""
    B, H, W, _ = dmap.shape
    pix = _pixel_grid(W, H, dmap.dtype, dmap.device)[None]    # (1, H, W, 2)
    c = K[:, :2, 2][:, None, None]
    f = torch.stack([K[:, 0, 0], K[:, 1, 1]], -1)[:, None, None]
    rays = (pix - c) / f
    rays = torch.cat([rays, torch.ones_like(rays[..., :1])], dim=-1)
    pts = rays * dmap                                           # (B, H, W, 3)

    def pad(x):  # edge padding of (B, H, W, C) by one pixel
        return F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1),
                     mode="replicate").permute(0, 2, 3, 1)

    pts_p = pad(pts)
    d_p = pad(dmap)[..., 0]

    vdiff = pts_p[:, 2:, 1:-1] - pts_p[:, :-2, 1:-1]
    hdiff = pts_p[:, 1:-1, 2:] - pts_p[:, 1:-1, :-2]
    normal = torch.linalg.cross(vdiff, hdiff, dim=-1)
    norm = torch.sqrt((normal * normal).sum(-1, keepdim=True))
    normal = normal / torch.where(norm == 0, torch.ones_like(norm), norm)

    inv_down = (d_p[:, 2:, 1:-1] == 0).to(torch.int64)
    inv_up = (d_p[:, :-2, 1:-1] == 0).to(torch.int64)
    inv_right = (d_p[:, 1:-1, 2:] == 0).to(torch.int64)
    inv_left = (d_p[:, 1:-1, :-2] == 0).to(torch.int64)
    off_y = inv_up - inv_down
    off_x = inv_left - inv_right

    iy = (torch.arange(H, device=dmap.device)[None, :, None] + off_y
          ).clamp(0, H - 1)
    ix = (torch.arange(W, device=dmap.device)[None, None, :] + off_x
          ).clamp(0, W - 1)
    idx = (iy * W + ix).reshape(B, H * W, 1).expand(B, H * W, 3)
    borrowed = torch.gather(normal.reshape(B, H * W, 3), 1, idx
                            ).reshape(B, H, W, 3)

    needs_repair = ((off_y != 0) | (off_x != 0))[..., None]
    normal = torch.where(needs_repair, borrowed, normal)
    return torch.where(dmap == 0, torch.zeros_like(normal), normal)
