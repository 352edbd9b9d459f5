"""Camera-sweep videos (port of diner_tpu.eval.sweep).

For chosen dataset samples: encode once, render `nframes` views along the
dataset's sweep trajectory, stack the rgb over the viridis depth, play the
frames forward and back, and write a video and a strip of the source
images. The video is an mp4 through imageio, else through cv2 (the JAX
package's order).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from diner_tpu_torch.data.contract import collate, to_device_batch
from diner_tpu_torch.image_ops.colormap import colormap


def save_video(frames01, outpath, fps: int = 5) -> None:
    """frames01: (N, H, W, 3) floats in [0, 1] -> an mp4 at outpath, by
    imageio when it and its ffmpeg plugin are there, else by cv2."""
    frames = (np.clip(np.asarray(frames01), 0, 1) * 255).astype(np.uint8)
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(outpath, list(frames), fps=fps, quality=10)
        return
    except Exception:  # no imageio, or no ffmpeg plugin for it: try cv2
        pass
    import cv2

    h, w = frames.shape[1:3]
    vw = cv2.VideoWriter(str(outpath), cv2.VideoWriter_fourcc(*"mp4v"),
                         fps, (w, h))
    try:
        for f in frames:
            vw.write(f[..., ::-1])  # RGB -> BGR
    finally:
        vw.release()


def _save_jpg(path, img01):
    from PIL import Image

    Image.fromarray((np.clip(np.asarray(img01), 0, 1) * 255
                     ).astype(np.uint8)).save(path)


def create_cam_sweep(render_fn, dataset, outdir, nframes: int = 30,
                     n_cam_sweeps: int = 4, fps: int = 5, sample_idcs=None):
    """render_fn(batch, target_extrinsics (1, 4, 4), seed) -> (rgb (1, H, W,
    3), depth (1, H, W)) as numpy arrays, batch a collated sample of numpy
    arrays. Writes one video per chosen sample and returns outdir."""
    outdir = Path(outdir)
    os.makedirs(outdir, exist_ok=True)
    if sample_idcs is None:
        sample_idcs = np.linspace(0, len(dataset) - 1,
                                  n_cam_sweeps).astype(int)

    for idx in sample_idcs:
        sample = dataset[int(idx)]
        batch = to_device_batch(collate([sample]))
        sweep = dataset.get_cam_sweep_extrinsics(nframes, scan_idx=int(idx))

        rgbs, depths = [], []
        for i in range(nframes):
            rgb, depth = render_fn(batch, np.asarray(sweep[i:i + 1]), i)
            rgbs.append(np.asarray(rgb)[0])
            depths.append(np.asarray(depth)[0])
        rgbs = np.stack(rgbs)
        d = np.stack(depths)[..., None]
        # one normalization range for the whole sweep: per-frame min/max
        # would make the depth half flicker as the nearest visible depth
        # changes with the orbiting camera
        depths = colormap(d, vmin=float(d.min()), vmax=float(d.max()))

        frames = np.concatenate([rgbs, depths], axis=1)  # stack vertically
        order = np.concatenate([np.arange(nframes),
                                np.arange(nframes - 1, 0, -1)])
        name = sample.get("sample_name", f"sweep_{idx}")
        save_video(frames[order], outdir / f"{name}.mp4", fps)
        refs = np.concatenate(list(sample["src_rgbs"]), axis=1)
        _save_jpg(outdir / f"{name}-ref_imgs.jpg", refs)
    return outdir
