"""Camera transforms and pinhole projection (port of diner_tpu.geometry.cameras).

uv is normalized so that +-1 are the outer edges of the border pixels
(align_corners=False).
"""

from __future__ import annotations

import torch


def invert_pose(extrinsics):
    """Invert rigid world->cam transforms (..., 4, 4) -> cam->world
    (..., 4, 4)."""
    rot = extrinsics[..., :3, :3].transpose(-1, -2)
    t = -(rot @ extrinsics[..., :3, 3:4])
    out = torch.zeros_like(extrinsics)
    out[..., :3, :3] = rot
    out[..., :3, 3:4] = t
    out[..., 3, 3] = 1.0
    return out


def ray_closest_points(ray1, ray2):
    """The points of two rays (6,) [origin xyz, direction xyz] where they
    come closest: the least-squares ray parameters by the SVD's
    pseudo-inverse (the minimum-norm solution, as jnp.linalg.lstsq's).
    Returns (x1, x2), each (3,)."""
    b = (ray2[:3] - ray1[:3])[:, None]                     # (3, 1)
    a = torch.stack([ray1[3:], -ray2[3:]], dim=-1)          # (3, 2)
    t = (torch.linalg.pinv(a) @ b).flatten()
    return ray1[:3] + ray1[3:] * t[0], ray2[:3] + ray2[3:] * t[1]


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
