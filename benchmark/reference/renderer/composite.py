"""NeRF alpha compositing over sorted z samples (port of
diner_tpu.renderer.composite).

Last delta = far - z_K; alpha = 1 - exp(-delta * relu(sigma)); the
transmittance cumprod carries the reference's 1e-10 stabilizer; an optional
white background adds (1 - sum w).

`composite` and `composite_outputs` return the weights, for the callers that
need them (training). The render path composites through kernel K4,
`kernels.composite.composite_rays`, which returns (rgb, depth, acc) only.
"""

from __future__ import annotations

from reference.kernels.composite import composite_outputs

__all__ = ["composite", "composite_outputs", "sample_points"]


def sample_points(rays, z_samp):
    """(points, dirs), each (SB, B*K, 3), for the field."""
    SB, B, K = z_samp.shape
    points = rays[..., None, :3] + z_samp[..., None] * rays[..., None, 3:6]
    dirs = rays[..., None, 3:6].expand(points.shape)
    return points.reshape(SB, B * K, 3), dirs.reshape(SB, B * K, 3)


def composite(field_fn, rays, z_samp, white_bkgd: bool = False):
    """field_fn (xyz (SB, N, 3), dirs (SB, N, 3)) -> (SB, N, 4); rays
    (SB, B, 8); z_samp (SB, B, K) ascending. Returns (weights, rgb, depth)."""
    points, dirs = sample_points(rays, z_samp)
    return composite_outputs(rays, z_samp, field_fn(points, dirs), white_bkgd)
