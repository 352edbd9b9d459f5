"""Procedural multi-view sphere scenes with analytic depth, and the sample-dict
contract they follow.

A numpy copy of `diner_tpu.data.synthetic` and the parts of
`diner_tpu.data.contract` it needs: the same seed gives the same arrays, so
the port and the JAX package render the same scenes. Layout is NHWC:

| key               | shape            | meaning                              |
|-------------------|------------------|--------------------------------------|
| target_rgb        | (H, W, 3) 0..1   | GT novel view                        |
| target_alpha      | (H, W, 1)        | fg mask                              |
| target_extrinsics | (4, 4)           | world->cam, OpenCV                   |
| target_intrinsics | (3, 3)           | K                                    |
| src_rgbs          | (NV, H, W, 3)    | source views                         |
| src_alphas        | (NV, H, W, 1)    | source fg masks                      |
| src_depths        | (NV, H, W, 1)    | MVS depth, metric, 0 = invalid       |
| src_depth_stds    | (NV, H, W, 1)    | per-pixel sigma                      |
| src_extrinsics    | (NV, 4, 4)       | source cams                          |
| src_intrinsics    | (NV, 3, 3)       | source K                             |
| sample_name       | str              | bookkeeping (non-array)              |
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

SAMPLE_KEYS = (
    "target_rgb", "target_alpha", "target_extrinsics", "target_intrinsics",
    "src_rgbs", "src_alphas", "src_depths", "src_depth_stds",
    "src_extrinsics", "src_intrinsics",
)


def validate_sample(sample: Dict) -> None:
    """Raise on contract violations (shapes, depth range)."""
    for k in SAMPLE_KEYS:
        if k not in sample:
            raise KeyError(f"sample missing contract key {k!r}")
    H, W, _ = sample["target_rgb"].shape
    NV = sample["src_rgbs"].shape[0]
    expect = {
        "target_rgb": (H, W, 3), "target_alpha": (H, W, 1),
        "target_extrinsics": (4, 4), "target_intrinsics": (3, 3),
        "src_rgbs": (NV, H, W, 3), "src_alphas": (NV, H, W, 1),
        "src_depths": (NV, H, W, 1), "src_depth_stds": (NV, H, W, 1),
        "src_extrinsics": (NV, 4, 4), "src_intrinsics": (NV, 3, 3),
    }
    for k, s in expect.items():
        if tuple(sample[k].shape) != s:
            raise ValueError(
                f"{k}: expected shape {s}, got {tuple(sample[k].shape)}")
    if np.any(np.asarray(sample["src_depths"]) < 0):
        raise ValueError("src_depths must be >= 0 (0 marks invalid)")


def collate(samples: List[Dict]) -> Dict:
    """Stack samples into a batch; array keys only, others listed."""
    out = {}
    for k in samples[0]:
        v0 = samples[0][k]
        if isinstance(v0, np.ndarray):
            out[k] = np.stack([np.asarray(s[k]) for s in samples])
        else:
            out[k] = [s[k] for s in samples]
    return out


def _lookat(eye, target=(0.0, 0.0, 0.0), up=(0.0, -1.0, 0.0)):
    eye = np.asarray(eye, np.float32)
    z = np.asarray(target, np.float32) - eye
    z /= np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float32), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    ext = np.eye(4, dtype=np.float32)
    ext[:3, :3] = np.stack([x, y, z])
    ext[:3, 3] = -ext[:3, :3] @ eye
    return ext


def _gen_rays_np(ext, K, W, H):
    xs, ys = np.meshgrid(np.arange(0.5, W), np.arange(0.5, H))
    pix = np.stack([xs, ys], -1).astype(np.float32)
    cam = (pix - K[:2, 2]) / np.array([K[0, 0], K[1, 1]], np.float32)
    cam = np.concatenate([cam, np.ones_like(cam[..., :1])], -1)
    dirs_cam = cam / np.linalg.norm(cam, axis=-1, keepdims=True)
    R = ext[:3, :3].T
    dirs = dirs_cam @ R.T
    origin = -R @ ext[:3, 3]
    return origin, dirs


class SyntheticSphereDataset:
    """len() scenes; each scene = a few colored spheres viewed from a circle.

    __getitem__ returns the sample dict above. Depth maps are exact z-depth
    along the optical axis; depth_std is constant where a sphere is hit and 0
    on the background.
    """

    znear = 1.0
    zfar = 3.5

    def __init__(self, n_scenes: int = 4, n_views: int = 4, H: int = 64,
                 W: int = 64, depth_std: float = 0.01, seed: int = 0):
        self.n_scenes = n_scenes
        self.n_views = n_views
        self.H, self.W = H, W
        self.depth_std = depth_std
        self.seed = seed

    def __len__(self):
        return self.n_scenes

    def _scene(self, idx):
        rng = np.random.RandomState(self.seed + 1000 * idx)
        n_spheres = 2 + rng.randint(2)
        centers = rng.uniform(-0.45, 0.45, (n_spheres, 3)).astype(np.float32)
        radii = rng.uniform(0.25, 0.45, n_spheres).astype(np.float32)
        colors = rng.uniform(0.2, 1.0, (n_spheres, 3)).astype(np.float32)
        return centers, radii, colors

    def _cameras(self, idx):
        rng = np.random.RandomState(self.seed + 1000 * idx + 7)
        K = np.array([[0.9 * self.W, 0, self.W / 2],
                      [0, 0.9 * self.W, self.H / 2],
                      [0, 0, 1]], np.float32)
        angles = np.linspace(0, 2 * np.pi, self.n_views + 1, endpoint=False)
        angles = angles + rng.uniform(0, 0.3)
        exts = []
        for a in angles:
            eye = np.array([2.2 * np.sin(a), 0.4 * np.cos(2 * a),
                            -2.2 * np.cos(a)])
            exts.append(_lookat(eye))
        return K, np.stack(exts)

    def _render_view(self, ext, K, centers, radii, colors):
        origin, dirs = _gen_rays_np(ext, K, self.W, self.H)
        t_best = np.full((self.H, self.W), np.inf, np.float32)
        rgb = np.full((self.H, self.W, 3), 0.05, np.float32)  # dark bg
        for c, r, col in zip(centers, radii, colors):
            oc = origin - c
            b = dirs @ oc
            disc = b * b - (oc @ oc - r * r)
            hit = disc > 0
            t = -b - np.sqrt(np.maximum(disc, 0))
            valid = hit & (t > 0) & (t < t_best)
            pts = origin + t[..., None] * dirs
            n = (pts - c) / r
            light = np.clip(n @ np.array([0.3, -0.5, -0.8], np.float32), 0, 1)
            shade = (0.35 + 0.65 * light)[..., None] * col
            rgb = np.where(valid[..., None], shade.astype(np.float32), rgb)
            t_best = np.where(valid, t, t_best)
        alpha = np.isfinite(t_best).astype(np.float32)
        dirs_cam_z = (dirs @ ext[:3, :3].T)[..., 2]
        depth = np.where(alpha > 0,
                         np.nan_to_num(t_best, posinf=0) * dirs_cam_z, 0)
        return rgb, alpha[..., None], depth[..., None].astype(np.float32)

    def __getitem__(self, idx):
        centers, radii, colors = self._scene(idx)
        K, exts = self._cameras(idx)

        srcs = [self._render_view(e, K, centers, radii, colors)
                for e in exts[: self.n_views]]
        tgt_rgb, tgt_alpha, _ = self._render_view(exts[-1], K, centers, radii,
                                                  colors)
        src_depths = np.stack([d for _, _, d in srcs])
        sample = {
            "target_rgb": tgt_rgb,
            "target_alpha": tgt_alpha,
            "target_extrinsics": exts[-1],
            "target_intrinsics": K,
            "src_rgbs": np.stack([r for r, _, _ in srcs]),
            "src_alphas": np.stack([a for _, a, _ in srcs]),
            "src_depths": src_depths,
            "src_depth_stds": np.where(src_depths > 0, self.depth_std, 0.0
                                       ).astype(np.float32),
            "src_extrinsics": np.broadcast_to(exts[: self.n_views],
                                              (self.n_views, 4, 4)).copy(),
            "src_intrinsics": np.broadcast_to(K, (self.n_views, 3, 3)).copy(),
            "sample_name": f"synthetic_{idx:04d}",
        }
        validate_sample(sample)
        return sample
