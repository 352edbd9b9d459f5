"""Ray and image rendering: depth-guided sampling + field evaluation +
compositing (port of diner_tpu.renderer.renderer).

Images are rendered in fixed-size ray chunks, one after the other. The
field function takes (points, dirs, epi_aux); epi_aux is the sampler's
EpiAnchors when RenderConfig.anchor_field_depth reuses them for the field's
MVS depth lookup, else None.

`render_image(..., split=(gather_fn, mlp_fn))` renders through
`render_flat_pipelined` instead: chunk i+1's sampler and latent gather run
while chunk i's MLP and compositing run, on a second CUDA stream.

Randomness: each chunk takes its noise as a (u_strat, g, u_fill) tuple
(see sample_depthguided), or draws it from a generator.

Spans (utils.profiling): `renderer.rays` around render_rays (one chunk of
render_flat_chunked, or a training step's rays) and `composite` around K4
on both routes; counters `renderer.chunks` and `renderer.padded_rays` (the
rays that repeat the last one to fill the last chunk).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from diner_tpu_torch.core.device import resolve_device
from diner_tpu_torch.core.types import RenderConfig, SceneEncoding
from diner_tpu_torch.kernels.composite import composite_rays
from diner_tpu_torch.renderer.composite import sample_points
from diner_tpu_torch.sampler.depth_guided import sample_depthguided
from diner_tpu_torch.utils.profiling import count, span

FieldFn = Callable[[torch.Tensor, torch.Tensor, Optional[object]],
                   torch.Tensor]


def render_rays(field_fn: FieldFn, rays, enc: SceneEncoding,
                cfg: RenderConfig, noise=None, generator=None):
    """rays (SB, B, 8) -> dict(rgb (SB, B, 3), depth (SB, B)); the field's
    outputs are composited by kernel K4. The sampler runs under no_grad, as
    the reference samples; gradients flow through the field and K4."""
    with span("renderer.rays"):
        with torch.no_grad():
            z, epi_aux = sample_depthguided(rays, enc, cfg, noise, generator,
                                            return_aux=True)
        if not cfg.anchor_field_depth:
            epi_aux = None
        points, dirs = sample_points(rays, z)
        out = field_fn(points, dirs, epi_aux)
        with span("composite"):
            rgb, depth, _ = composite_rays(rays, z, out, cfg.white_bkgd)
    return {"rgb": rgb, "depth": depth}


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
    count("renderer.chunks", n_chunks)
    count("renderer.padded_rays", SB * n_pad)
    return flat, n_chunks


def render_flat_chunked(field_fn: FieldFn, flat, enc: SceneEncoding,
                        cfg: RenderConfig, chunk: int,
                        noise: Optional[Sequence] = None, generator=None):
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
                          cfg, None if noise is None else noise[i], generator)
        rgbs.append(out["rgb"])
        depths.append(out["depth"])
    rgb = torch.cat(rgbs, dim=1)[:, :n]
    depth = torch.cat(depths, dim=1)[:, :n]
    return rgb, depth


def _record_stream(tree: Any, stream) -> None:
    """Mark every tensor of a nest of tuples, lists and dicts as used on
    `stream`, so that the caching allocator does not hand its memory out
    again before the work queued there has read it."""
    if isinstance(tree, torch.Tensor):
        tree.record_stream(stream)
    elif isinstance(tree, dict):
        for v in tree.values():
            _record_stream(v, stream)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _record_stream(v, stream)


def render_flat_pipelined(gather_fn, mlp_fn, flat, enc: SceneEncoding,
                          cfg: RenderConfig, chunk: int,
                          noise: Optional[Sequence] = None, generator=None):
    """Render a flat ray batch (SB, N, 8) in chunks, chunk i+1's `prep`
    (sampler, sample points, gather_fn) beside chunk i's `compute` (mlp_fn,
    then compositing by K4). The work is render_flat_chunked's, reordered:
    the same noise, or the same generator, gives the same outputs.

    gather_fn(points (SB, n, 3), epi_aux) -> gathered (e.g.
    PixelNeRF.field_gather); mlp_fn(gathered, points, dirs) -> (SB, n, 4)
    (e.g. PixelNeRF.field_mlp). On a CUDA device `prep` runs on a second
    stream, ordered against `compute` by events; on the CPU the two run in
    sequence. Returns (rgb (SB, N, 3), depth (SB, N)).
    """
    n = flat.shape[1]
    flat, n_chunks = _pad_to_chunks(flat, chunk, noise)
    dev = flat.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")

    def prep(i):
        rays = flat[:, i * chunk:(i + 1) * chunk]
        with torch.no_grad():
            z, epi_aux = sample_depthguided(
                rays, enc, cfg, None if noise is None else noise[i],
                generator, return_aux=True)
        points, dirs = sample_points(rays, z)
        gathered = gather_fn(points,
                             epi_aux if cfg.anchor_field_depth else None)
        return rays, z, points, dirs, gathered

    def compute(carry):
        rays, z, points, dirs, gathered = carry
        out = mlp_fn(gathered, points, dirs)
        with span("composite"):
            rgb, depth, _ = composite_rays(rays, z, out, cfg.white_bkgd)
        return rgb, depth

    rgbs, depths = [], []
    if dev.type == "cpu":
        for i in range(n_chunks):
            rgb, depth = compute(prep(i))
            rgbs.append(rgb)
            depths.append(depth)
    else:
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)   # flat, enc and the noise come from main

        def prep_on_side(i):
            with torch.cuda.stream(side):
                carry = prep(i)
                ready = torch.cuda.Event()
                ready.record(side)
            return carry, ready

        nxt = prep_on_side(0)
        for i in range(n_chunks):
            carry, ready = nxt
            main.wait_event(ready)
            _record_stream(carry, main)
            if i + 1 < n_chunks:
                nxt = prep_on_side(i + 1)
            rgb, depth = compute(carry)
            rgbs.append(rgb)
            depths.append(depth)
            del carry
    rgb = torch.cat(rgbs, dim=1)[:, :n]
    depth = torch.cat(depths, dim=1)[:, :n]
    return rgb, depth


@torch.inference_mode()
def render_image(field_fn: Optional[FieldFn], rays, enc: SceneEncoding,
                 cfg: RenderConfig, chunk: int = 4096, noise=None,
                 seed: int = 0, device="cuda", split=None):
    """Render full images: rays (SB, H, W, 8) -> (rgb (SB, H, W, 3),
    depth (SB, H, W)) on `device` (CUDA unless the caller asks for "cpu").

    noise: optional per-chunk noise tuples; without it, draws come from a
    torch.Generator seeded with `seed`. split: an optional (gather_fn,
    mlp_fn) pair that renders through render_flat_pipelined; field_fn is
    then not used.
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
    if split is not None:
        rgb, depth = render_flat_pipelined(split[0], split[1], flat, enc,
                                           cfg, chunk, noise, generator)
    else:
        rgb, depth = render_flat_chunked(field_fn, flat, enc, cfg, chunk,
                                         noise, generator)
    return rgb.reshape(SB, H, W, 3), depth.reshape(SB, H, W)
