"""Ray and image rendering: depth-guided sampling + field evaluation +
compositing (port of render_rays, render_flat_chunked and render_image of
diner_tpu.renderer.renderer).

Images are rendered in fixed-size ray chunks, one after the other. The
field function takes (points, dirs, epi_aux); epi_aux is the sampler's
EpiAnchors when RenderConfig.anchor_field_depth reuses them for the field's
MVS depth lookup, else None.

Randomness: each chunk takes its noise as a (u_strat, g, u_fill) tuple
(see sample_depthguided), or draws it from a generator.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from diner_tpu_torch.core.device import resolve_device
from diner_tpu_torch.core.types import RenderConfig, SceneEncoding
from diner_tpu_torch.kernels.composite import composite_rays
from diner_tpu_torch.renderer.composite import sample_points
from diner_tpu_torch.sampler.depth_guided import sample_depthguided

FieldFn = Callable[[torch.Tensor, torch.Tensor, Optional[object]],
                   torch.Tensor]


def render_rays(field_fn: FieldFn, rays, enc: SceneEncoding,
                cfg: RenderConfig, noise=None, generator=None):
    """rays (SB, B, 8) -> dict(rgb (SB, B, 3), depth (SB, B)); the field's
    outputs are composited by kernel K4."""
    z, epi_aux = sample_depthguided(rays, enc, cfg, noise, generator,
                                    return_aux=True)
    if not cfg.anchor_field_depth:
        epi_aux = None
    points, dirs = sample_points(rays, z)
    rgb, depth, _ = composite_rays(rays, z, field_fn(points, dirs, epi_aux),
                                   cfg.white_bkgd)
    return {"rgb": rgb, "depth": depth}


def render_flat_chunked(field_fn: FieldFn, flat, enc: SceneEncoding,
                        cfg: RenderConfig, chunk: int,
                        noise: Optional[Sequence] = None, generator=None):
    """Render a flat ray batch (SB, N, 8) in chunks of `chunk` rays.

    N is padded to a chunk multiple (padded rays repeat the last ray).
    noise: optional per-chunk noise tuples. Returns (rgb (SB, N, 3),
    depth (SB, N)).
    """
    SB, n = flat.shape[:2]
    n_chunks = -(-n // chunk)
    n_pad = n_chunks * chunk - n
    if n_pad:
        flat = torch.cat([flat, flat[:, -1:].expand(SB, n_pad, 8)], dim=1)
    if noise is not None and len(noise) != n_chunks:
        raise ValueError(f"noise for {len(noise)} chunks, need {n_chunks}")
    rgbs, depths = [], []
    for i in range(n_chunks):
        out = render_rays(field_fn, flat[:, i * chunk:(i + 1) * chunk], enc,
                          cfg, None if noise is None else noise[i], generator)
        rgbs.append(out["rgb"])
        depths.append(out["depth"])
    rgb = torch.cat(rgbs, dim=1)[:, :n]
    depth = torch.cat(depths, dim=1)[:, :n]
    return rgb, depth


@torch.inference_mode()
def render_image(field_fn: FieldFn, rays, enc: SceneEncoding,
                 cfg: RenderConfig, chunk: int = 4096, noise=None,
                 seed: int = 0, device="cuda"):
    """Render full images: rays (SB, H, W, 8) -> (rgb (SB, H, W, 3),
    depth (SB, H, W)) on `device` (CUDA unless the caller asks for "cpu").

    noise: optional per-chunk noise tuples; without it, draws come from a
    torch.Generator seeded with `seed`.
    """
    dev = resolve_device(device)
    if enc.depths.device.type != dev.type:
        raise ValueError(f"scene encoding on {enc.depths.device}, render "
                         f"requested on {dev}")
    rays = rays.to(dev)
    if noise is not None:
        noise = [tuple(x.to(dev) for x in n) for n in noise]
    SB, H, W, _ = rays.shape
    generator = torch.Generator(device=dev).manual_seed(seed)
    rgb, depth = render_flat_chunked(field_fn, rays.reshape(SB, H * W, 8),
                                     enc, cfg, chunk, noise, generator)
    return rgb.reshape(SB, H, W, 3), depth.reshape(SB, H, W)
