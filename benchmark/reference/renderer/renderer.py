"""Ray and image rendering: depth-guided sampling + field evaluation +
compositing (port of diner_tpu.renderer.renderer).

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

from reference.core.device import resolve_device
from reference.core.types import RenderConfig, SceneEncoding
from reference.kernels.composite import composite_rays
from reference.renderer.composite import sample_points
from reference.sampler.depth_guided import sample_depthguided

FieldFn = Callable[[torch.Tensor, torch.Tensor, Optional[object]],
                   torch.Tensor]


def render_rays(field_fn: FieldFn, rays, enc: SceneEncoding,
                cfg: RenderConfig, noise=None, generator=None,
                render_dtype=None):
    """rays (SB, B, 8) -> dict(rgb (SB, B, 3), depth (SB, B)); the field's
    outputs are composited by kernel K4. The sampler runs under no_grad, as
    the reference samples; gradients flow through the field and K4.
    render_dtype (a control's): the sampler's depths are rounded to that
    type and the compositing runs in it, instead of float32."""
    with torch.no_grad():
        z, epi_aux = sample_depthguided(rays, enc, cfg, noise, generator,
                                        return_aux=True)
    if not cfg.anchor_field_depth:
        epi_aux = None
    if render_dtype is not None:
        z = z.to(render_dtype).float()
    points, dirs = sample_points(rays, z)
    out = field_fn(points, dirs, epi_aux)
    if render_dtype is not None:
        rays, z, out = (x.to(render_dtype) for x in (rays, z, out))
    rgb, depth, _ = composite_rays(rays, z, out, cfg.white_bkgd)
    return {"rgb": rgb.float(), "depth": depth.float()}


def _pad_to_chunks(flat, chunk: int, noise):
    """(flat padded to a multiple of `chunk` rays by repeating the last ray,
    the number of chunks); per-chunk noise must have one entry a chunk."""
    SB, n = flat.shape[:2]
    n_chunks = -(-n // chunk)
    n_pad = n_chunks * chunk - n
    if n_pad:
        flat = torch.cat([flat, flat[:, -1:].expand(SB, n_pad, 8)], dim=1)
    if noise is not None and len(noise) != n_chunks:
        raise ValueError(f"noise for {len(noise)} chunks, need {n_chunks}")
    return flat, n_chunks


def render_flat_chunked(field_fn: FieldFn, flat, enc: SceneEncoding,
                        cfg: RenderConfig, chunk: int,
                        noise: Optional[Sequence] = None, generator=None,
                        render_dtype=None):
    """Render a flat ray batch (SB, N, 8) in chunks of `chunk` rays.

    N is padded to a chunk multiple (padded rays repeat the last ray).
    noise: optional per-chunk noise tuples. Returns (rgb (SB, N, 3),
    depth (SB, N)).
    """
    n = flat.shape[1]
    flat, n_chunks = _pad_to_chunks(flat, chunk, noise)
    rgbs, depths = [], []
    for i in range(n_chunks):
        out = render_rays(field_fn, flat[:, i * chunk:(i + 1) * chunk], enc,
                          cfg, None if noise is None else noise[i], generator,
                          render_dtype)
        rgbs.append(out["rgb"])
        depths.append(out["depth"])
    rgb = torch.cat(rgbs, dim=1)[:, :n]
    depth = torch.cat(depths, dim=1)[:, :n]
    return rgb, depth


@torch.inference_mode()
def render_image(field_fn: Optional[FieldFn], rays, enc: SceneEncoding,
                 cfg: RenderConfig, chunk: int = 4096, noise=None,
                 seed: int = 0, device="cuda", render_dtype=None):
    """Render full images: rays (SB, H, W, 8) -> (rgb (SB, H, W, 3),
    depth (SB, H, W)) on `device` (CUDA unless the caller asks for "cpu").

    noise: optional per-chunk noise tuples; without it, draws come from a
    torch.Generator seeded with `seed`. render_dtype: see render_rays.
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
    flat = rays.reshape(SB, H * W, 8)
    rgb, depth = render_flat_chunked(field_fn, flat, enc, cfg, chunk,
                                     noise, generator, render_dtype)
    return rgb.reshape(SB, H, W, 3), depth.reshape(SB, H, W)
