"""K4's plain PyTorch version (frozen copy of the port's
`composite_outputs` and `composite_rays_plain`); its gradient is
autograd's."""

from __future__ import annotations

import torch


def composite_outputs(rays, z_samp, out, white_bkgd: bool = False):
    """Composite field outputs out (SB, B*K, 4) [rgb, sigma] at the points of
    `sample_points`. Returns (weights (SB, B, K), rgb (SB, B, 3),
    depth (SB, B)).

    Last delta = far - z_K; alpha = 1 - exp(-delta * relu(sigma)); the
    transmittance cumprod carries the reference's 1e-10 stabilizer; an
    optional white background adds (1 - sum w)."""
    SB, B, K = z_samp.shape
    deltas = torch.cat([z_samp[..., 1:] - z_samp[..., :-1],
                        rays[..., 7:8] - z_samp[..., -1:]], dim=-1)
    out = out.reshape(SB, B, K, 4)
    rgbs = out[..., :3]
    sigmas = out[..., 3]

    # torch.maximum, like jnp.maximum, splits a tie's gradient evenly
    alphas = 1.0 - torch.exp(-deltas * torch.maximum(sigmas,
                                                      sigmas.new_zeros(())))
    trans = torch.cumprod(torch.cat([torch.ones_like(alphas[..., :1]),
                                     1.0 - alphas + 1e-10], dim=-1), dim=-1)
    weights = alphas * trans[..., :-1]

    rgb = (weights[..., None] * rgbs).sum(-2)
    depth = (weights * z_samp).sum(-1)
    if white_bkgd:
        rgb = rgb + (1.0 - weights.sum(-1, keepdim=True))
    return weights, rgb, depth


def composite_rays_plain(rays, z_samp, field_out, white_bkgd: bool = False):
    """The same function in plain PyTorch, on any device."""
    weights, rgb, depth = composite_outputs(rays, z_samp, field_out,
                                            white_bkgd)
    return rgb, depth, weights.sum(-1)


composite_rays = composite_rays_plain
