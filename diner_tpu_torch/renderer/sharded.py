"""Rendering with the rays sharded over devices (port of
diner_tpu.renderer.sharded).

Rays are independent: a full-image render splits the flat ray axis into one
slice a device, each device renders its slice with render_flat_chunked
against its own copy of the scene encoding, and the image is put back
together in ray order. No collectives are needed.

The field function takes the encoding first:

    field_fn(enc, pts, dirs, epi_aux=None) -> (SB, N, 4)

and must use only the encoding it is given (and parameters on pts.device).
A device may appear more than once in `devices` (["cuda:0", "cuda:0"]
renders two shards on one card, ["cpu"] * 4 four on the CPU); each distinct
device renders its shards in order from a host thread of its own.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from diner_tpu_torch.core.device import resolve_device
from diner_tpu_torch.core.types import RenderConfig, SceneEncoding
from diner_tpu_torch.renderer.renderer import render_flat_chunked


def shard_rays(rays, n_shards: int):
    """rays (SB, H, W, 8) -> (n_shards, SB, per, 8): the flat ray axis
    padded to a multiple of n_shards by repeating the last ray, and split."""
    SB, H, W, _ = rays.shape
    n = H * W
    per = -(-n // n_shards)
    flat = rays.reshape(SB, n, 8)
    n_pad = per * n_shards - n
    if n_pad:
        flat = torch.cat([flat, flat[:, -1:].expand(SB, n_pad, 8)], dim=1)
    return flat.reshape(SB, n_shards, per, 8).transpose(0, 1)


def render_image_sharded(field_fn, rays, enc: SceneEncoding,
                         cfg: RenderConfig, devices: Sequence,
                         chunk: int = 4096,
                         noise: Optional[Sequence[Sequence]] = None,
                         seed: int = 0):
    """rays (SB, H, W, 8) -> (rgb (SB, H, W, 3), depth (SB, H, W)) on
    devices[0].

    devices: one entry a shard ("cuda:0", "cuda:1", ... or "cpu"; repeats
    allowed). noise: optional, one list of per-chunk noise tuples a shard;
    without it, shard d draws from a generator seeded from (seed, d), as
    the JAX package folds the shard index into its key.
    """
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("no devices to shard over")
    if noise is not None and len(noise) != len(devs):
        raise ValueError(f"noise for {len(noise)} shards, need {len(devs)}")
    SB, H, W, _ = rays.shape
    shards = shard_rays(rays, len(devs))
    outs = [None] * len(devs)

    def render_shard(d: int):
        dev = devs[d]
        enc_d = enc.to(dev)
        shard_noise = None if noise is None else [
            tuple(x.to(dev) for x in n) for n in noise[d]]
        generator = torch.Generator(device=dev).manual_seed(int(
            np.random.SeedSequence([seed, d]).generate_state(1)[0]))
        outs[d] = render_flat_chunked(
            lambda p, v, aux: field_fn(enc_d, p, v, aux),
            shards[d].to(dev), enc_d, cfg, chunk, shard_noise, generator)

    by_device = {}
    for d, dev in enumerate(devs):
        by_device.setdefault(dev, []).append(d)
    groups = list(by_device.items())
    errors = []

    def worker(dev, ids):
        # inference mode and the current card are a thread's own
        on_card = (torch.cuda.device(dev) if dev.type == "cuda"
                   else contextlib.nullcontext())
        try:
            with torch.inference_mode(), on_card:
                for d in ids:
                    render_shard(d)
        except BaseException as e:  # re-raised in the calling thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=g) for g in groups[1:]]
    for t in threads:
        t.start()
    worker(*groups[0])
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    out = devs[0]
    rgb = torch.cat([o[0].to(out) for o in outs], dim=1)[:, :H * W]
    depth = torch.cat([o[1].to(out) for o in outs], dim=1)[:, :H * W]
    return rgb.reshape(SB, H, W, 3), depth.reshape(SB, H, W)
