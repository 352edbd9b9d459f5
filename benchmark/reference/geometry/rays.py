"""Camera ray generation, OpenCV pinhole convention (port of
diner_tpu.geometry.rays).

Rays are [origin(3), unit direction(3), near(1), far(1)]; pixel centers sit at
integer+0.5 screen coordinates, so z along a ray is distance, not depth.
"""

from __future__ import annotations

import torch


def _pixel_grid(W: int, H: int, dtype, device):
    """(H, W, 2) [x, y] pixel centers."""
    xs = torch.arange(0.5, W, 1.0, dtype=dtype, device=device)
    ys = torch.arange(0.5, H, 1.0, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def gen_rays(extrinsics, intrinsics, W: int, H: int, z_near, z_far):
    """extrinsics (B, 4, 4) world->cam; intrinsics (B, 3, 3); z_near/z_far
    scalars or (B,). Returns (B, H, W, 8)."""
    B = extrinsics.shape[0]
    dtype, device = extrinsics.dtype, extrinsics.device

    focal = torch.stack([intrinsics[:, 0, 0], intrinsics[:, 1, 1]], -1)
    c = intrinsics[:, :2, 2]
    pix = _pixel_grid(W, H, dtype, device)

    cam = (pix[None] - c[:, None, None]) / focal[:, None, None]
    cam = torch.cat([cam, torch.ones_like(cam[..., :1])], dim=-1)
    dirs_cam = cam / torch.sqrt((cam * cam).sum(-1, keepdim=True))

    rot_c2w = extrinsics[:, :3, :3].transpose(-1, -2)           # (B, 3, 3)
    dirs_world = torch.einsum("bij,bhwj->bhwi", rot_c2w, dirs_cam)
    centers = -torch.einsum("bij,bj->bi", rot_c2w, extrinsics[:, :3, 3])
    origins = centers[:, None, None].expand(B, H, W, 3)

    def _bounds(v):
        v = torch.as_tensor(v, dtype=dtype, device=device).reshape(-1, 1, 1, 1)
        return v.expand(B, H, W, 1)

    return torch.cat([origins, dirs_world, _bounds(z_near), _bounds(z_far)],
                     dim=-1)
