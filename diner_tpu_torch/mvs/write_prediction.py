"""Depth-prior writing (port of diner_tpu.mvs.write_prediction): the files
the DINER readers take their MVS priors from.

For each MVS sample, next to the dataset's GT depth path:
  <depthstem>_TransMVSNet.png       uint16, 1e-4 units of depth / `scale`
  <depthstem>_TransMVSNet_conf.png  the confidence, same encoding
  <depthstem>_TransMVSNet_vis.png   8-bit preview
DTU writes depth / (872 / 0.7), TransMVSNet's training scale. The PNGs go
through the port's own codec (image_ops/png.py).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from diner_tpu_torch.data.codecs import (DEPTH_SCALE_FACTOR, write_pfm,
                                         write_png16)
from diner_tpu_torch.image_ops.png import write_png


def write_depth_prediction(depth, confidence, dpath,
                           suffix: str = "TransMVSNet", scale: float = 1.0,
                           mask=None):
    """depth, confidence: (H, W) float arrays; dpath: the dataset's GT depth
    path, whose stem names the outputs. Returns the depth PNG's path."""
    dpath = Path(dpath)
    depth = np.asarray(depth, np.float64) / scale
    conf = np.asarray(confidence, np.float64)
    if mask is not None:
        depth = depth * (np.asarray(mask) > 0)
        conf = conf * (np.asarray(mask) > 0)

    stem, out = dpath.stem, dpath.parent
    out.mkdir(parents=True, exist_ok=True)
    top = np.iinfo(np.uint16).max
    write_png16(out / f"{stem}_{suffix}.png",
                np.clip(depth / DEPTH_SCALE_FACTOR, 0, top).astype(np.uint16))
    write_png16(out / f"{stem}_{suffix}_conf.png",
                np.clip(conf / DEPTH_SCALE_FACTOR, 0, top).astype(np.uint16))
    vis = depth - depth[depth > 0].min() if (depth > 0).any() else depth
    vmax = vis.max() if vis.max() > 0 else 1.0
    write_png(out / f"{stem}_{suffix}_vis.png",
              (np.clip(vis / vmax, 0, 1) * 255).astype(np.uint8))
    return out / f"{stem}_{suffix}.png"


def make_proj_matrices(extrinsics, intrinsics):
    """The cascade's per-stage [extrinsics, intrinsics] stacks.

    extrinsics: (B, V, 4, 4); intrinsics: (B, V, 3, 3) at full resolution.
    Returns {"stage1".."stage3": (B, V, 2, 4, 4)} with the intrinsics
    scaled by 1/4, 1/2 and 1.
    """
    B, V = np.asarray(extrinsics).shape[:2]
    out = {}
    for stage, s in (("stage1", 4.0), ("stage2", 2.0), ("stage3", 1.0)):
        K4 = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
        K = np.asarray(intrinsics, np.float32).copy()
        K[..., :2, :] /= s
        K4[..., :3, :3] = K
        out[stage] = np.stack([np.asarray(extrinsics, np.float32), K4],
                              axis=2)
    return out


def save_scene_depth_pfm(depth, stage_confidences, out_dir, view_idx: int):
    """depth_est/<view>.pfm and confidence/<view>.pfm under out_dir, the
    confidence the product of the per-stage confidences, each
    nearest-upsampled to the depth's resolution."""
    out_dir = Path(out_dir)
    (out_dir / "depth_est").mkdir(parents=True, exist_ok=True)
    (out_dir / "confidence").mkdir(parents=True, exist_ok=True)
    H, W = np.asarray(depth).shape
    conf = np.ones((H, W), np.float64)
    for c in stage_confidences:
        c = np.asarray(c, np.float64)
        if c.shape != (H, W):
            ys = (np.arange(H) * (c.shape[0] / H)).astype(np.int64)
            xs = (np.arange(W) * (c.shape[1] / W)).astype(np.int64)
            c = c[ys][:, xs]
        conf = conf * c
    write_pfm(out_dir / "depth_est" / f"{view_idx:08d}.pfm",
              np.asarray(depth, np.float32))
    write_pfm(out_dir / "confidence" / f"{view_idx:08d}.pfm",
              conf.astype(np.float32))
    return out_dir
