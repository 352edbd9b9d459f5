"""NeRF alpha compositing over sorted z samples (port of
diner_tpu.renderer.composite).

Last delta = far - z_K; alpha = 1 - exp(-delta * relu(sigma)); the
transmittance cumprod carries the reference's 1e-10 stabilizer; an optional
white background adds (1 - sum w).
"""

from __future__ import annotations

import torch


def sample_points(rays, z_samp):
    """(points, dirs), each (SB, B*K, 3), for the field."""
    SB, B, K = z_samp.shape
    points = rays[..., None, :3] + z_samp[..., None] * rays[..., None, 3:6]
    dirs = rays[..., None, 3:6].expand(points.shape)
    return points.reshape(SB, B * K, 3), dirs.reshape(SB, B * K, 3)


def composite_outputs(rays, z_samp, out, white_bkgd: bool = False):
    """Composite field outputs out (SB, B*K, 4) [rgb, sigma] at the points of
    `sample_points`. Returns (weights (SB, B, K), rgb (SB, B, 3),
    depth (SB, B))."""
    SB, B, K = z_samp.shape
    deltas = torch.cat([z_samp[..., 1:] - z_samp[..., :-1],
                        rays[..., 7:8] - z_samp[..., -1:]], dim=-1)
    out = out.reshape(SB, B, K, 4)
    rgbs = out[..., :3]
    sigmas = out[..., 3]

    alphas = 1.0 - torch.exp(-deltas * sigmas.clamp(min=0.0))
    trans = torch.cumprod(torch.cat([torch.ones_like(alphas[..., :1]),
                                     1.0 - alphas + 1e-10], dim=-1), dim=-1)
    weights = alphas * trans[..., :-1]

    rgb = (weights[..., None] * rgbs).sum(-2)
    depth = (weights * z_samp).sum(-1)
    if white_bkgd:
        rgb = rgb + (1.0 - weights.sum(-1, keepdim=True))
    return weights, rgb, depth


def composite(field_fn, rays, z_samp, white_bkgd: bool = False):
    """field_fn (xyz (SB, N, 3), dirs (SB, N, 3)) -> (SB, N, 4); rays
    (SB, B, 8); z_samp (SB, B, K) ascending. Returns (weights, rgb, depth)."""
    points, dirs = sample_points(rays, z_samp)
    return composite_outputs(rays, z_samp, field_fn(points, dirs), white_bkgd)
