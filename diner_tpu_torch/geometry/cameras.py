"""Camera transforms and pinhole projection (port of diner_tpu.geometry.cameras).

uv is normalized so that +-1 are the outer edges of the border pixels
(align_corners=False).
"""

from __future__ import annotations

import torch


def transform_points(pose, xyz):
    """Apply rigid transforms: pose (..., 4, 4) or (..., 3, 4); xyz (..., N, 3)
    with broadcastable batch dims. Returns (..., N, 3)."""
    rot = pose[..., :3, :3]
    t = pose[..., :3, 3]
    return xyz @ rot.transpose(-1, -2) + t[..., None, :]


def project_points(xyz_cam, focal, c, image_shape):
    """Pinhole projection of camera-space points (..., N, 3) to normalized uv
    (..., N, 2). focal/c: (..., 2); image_shape: (W, H)."""
    wh = torch.tensor(image_shape, dtype=xyz_cam.dtype, device=xyz_cam.device)
    uv = xyz_cam[..., :2] / xyz_cam[..., 2:3]
    uv = uv * focal[..., None, :] + c[..., None, :]
    return uv / wh * 2.0 - 1.0
