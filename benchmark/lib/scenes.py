"""The benchmark's inputs, made from a seed: a frozen copy of the port's
synthetic sphere scenes (diner_tpu_torch/data/synthetic.py) and of
chip_smoke.py's DTU-tree writer, so that later changes to the port cannot
move what the benchmark feeds it. Numpy and Pillow only."""

from __future__ import annotations

import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ZNEAR, ZFAR = 1.0, 3.5        # the sphere scenes' depth range
# the data trees the benchmark writes once, at fixed paths in the checkout
CACHE = Path(__file__).resolve().parents[2] / "build" / "benchmark"


def lookat(eye, target=(0.0, 0.0, 0.0), up=(0.0, -1.0, 0.0)):
    """World->cam extrinsics (4, 4) at `eye` looking at `target`."""
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


def _rays(ext, K, W, H):
    xs, ys = np.meshgrid(np.arange(0.5, W), np.arange(0.5, H))
    pix = np.stack([xs, ys], -1).astype(np.float32)
    cam = (pix - K[:2, 2]) / np.array([K[0, 0], K[1, 1]], np.float32)
    cam = np.concatenate([cam, np.ones_like(cam[..., :1])], -1)
    dirs_cam = cam / np.linalg.norm(cam, axis=-1, keepdims=True)
    R = ext[:3, :3].T
    return -R @ ext[:3, 3], dirs_cam @ R.T


def sphere_scene(rng):
    """(centers, radii, colors) of 2 or 3 spheres drawn from `rng`."""
    n_spheres = 2 + rng.randint(2)
    centers = rng.uniform(-0.45, 0.45, (n_spheres, 3)).astype(np.float32)
    radii = rng.uniform(0.25, 0.45, n_spheres).astype(np.float32)
    colors = rng.uniform(0.2, 1.0, (n_spheres, 3)).astype(np.float32)
    return centers, radii, colors


def render_view(ext, K, H, W, centers, radii, colors):
    """(rgb (H, W, 3), alpha (H, W, 1), z-depth (H, W, 1)) of the spheres
    seen through K from `ext`; background rgb 0.05 and depth 0."""
    origin, dirs = _rays(ext, K, W, H)
    t_best = np.full((H, W), np.inf, np.float32)
    rgb = np.full((H, W, 3), 0.05, np.float32)
    for c, r, col in zip(centers, radii, colors):
        oc = origin - c
        b = dirs @ oc
        disc = b * b - (oc @ oc - r * r)
        t = -b - np.sqrt(np.maximum(disc, 0))
        valid = (disc > 0) & (t > 0) & (t < t_best)
        n = (origin + t[..., None] * dirs - c) / r
        light = np.clip(n @ np.array([0.3, -0.5, -0.8], np.float32), 0, 1)
        shade = (0.35 + 0.65 * light)[..., None] * col
        rgb = np.where(valid[..., None], shade.astype(np.float32), rgb)
        t_best = np.where(valid, t, t_best)
    alpha = np.isfinite(t_best).astype(np.float32)
    dirs_cam_z = (dirs @ ext[:3, :3].T)[..., 2]
    depth = np.where(alpha > 0, np.nan_to_num(t_best, posinf=0) * dirs_cam_z,
                     0)
    return rgb, alpha[..., None], depth[..., None].astype(np.float32)


def scene_pool(seed: int, n_scenes: int, n_views: int, H: int, W: int,
               depth_std: float):
    """`n_scenes` source-view sets, each a dict of (1, NV, ...) arrays
    (src_rgbs, src_depths, src_depth_stds, src_extrinsics,
    src_intrinsics) and `K`, the intrinsics the targets share."""
    rng = np.random.RandomState(seed % 2 ** 31)
    K = np.array([[0.9 * W, 0, W / 2], [0, 0.9 * W, H / 2], [0, 0, 1]],
                 np.float32)
    pool = []
    for _ in range(n_scenes):
        centers, radii, colors = sphere_scene(rng)
        a0 = rng.uniform(0, 2 * np.pi)
        exts = np.stack([lookat([2.2 * np.sin(a), 0.4 * np.cos(2 * a),
                                 -2.2 * np.cos(a)])
                         for a in a0 + np.arange(n_views) * 2 * np.pi
                         / n_views])
        views = [render_view(e, K, H, W, centers, radii, colors)
                 for e in exts]
        depths = np.stack([d for _, _, d in views])
        pool.append({
            "src_rgbs": np.stack([r for r, _, _ in views])[None],
            "src_depths": depths[None],
            "src_depth_stds": np.where(depths > 0, depth_std, 0.0).astype(
                np.float32)[None],
            "src_extrinsics": exts[None],
            "src_intrinsics": np.broadcast_to(K, (n_views, 3, 3))[None].copy(),
            "K": K})
    return pool


def cam_sweep(n_frames: int, radius: float = 2.2, height: float = 0.0):
    """(n_frames, 4, 4) world->cam extrinsics on a horizontal circle around
    the origin."""
    return np.stack([lookat([radius * np.sin(a), height, -radius * np.cos(a)])
                     for a in np.linspace(0, 2 * np.pi, n_frames,
                                          endpoint=False)])


# ---------------------------------------------------------------- DTU tree
DTU_SCALE_FACTOR = 0.7 / 872.0        # the DTU reader's default
DTU_SRC_CAMS = (30, 10, 6, 35)        # the reader's fixed source views
DTU_LIGHTS = 7
DTU_CAM_RADIUS, DTU_SCENE_SCALE = 0.76, 0.3
DTU_HW = (512, 640)


def _write_mvsnet_cam(path, extrinsics, intrinsics, depth_min, interval):
    with open(path, "w") as f:
        f.write("extrinsic\n")
        for row in np.asarray(extrinsics, np.float64):
            f.write(" ".join(f"{v:.8f}" for v in row) + "\n")
        f.write("\nintrinsic\n")
        for row in np.asarray(intrinsics, np.float64):
            f.write(" ".join(f"{v:.8f}" for v in row) + "\n")
        f.write(f"\n{depth_min} {interval}\n")


def _dtu_grid():
    """World->cam extrinsics of a 7 x 7 grid of cams about the scene."""
    return [lookat(DTU_CAM_RADIUS * np.array([
        np.sin(az) * np.cos(el), np.sin(el), -np.cos(az) * np.cos(el)]),
        up=np.array([0.0, -1.0, 0.0]))
        for el in np.linspace(-0.25, 0.25, 7)
        for az in np.linspace(-0.5, 0.5, 7)]


def tree_path(traffic: dict) -> Path:
    """Where a traffic mix's DTU tree lives: one per tree seed."""
    return CACHE / f"dtu_tree_{traffic['tree_seed']}"


def write_dtu_tree(root: Path, tree_seed: int, threads: int = 8) -> None:
    """A DTU-layout tree of one scan at the dataset's real size, as
    chip_smoke.py writes it: 49 MVSNet cam files (intrinsics at 1/4
    resolution, translations in mm), the 512x640 image of every cam under
    each of the 7 lights, and the uint16 TransMVSNet depth and confidence
    PNGs of the source cams, of a sphere scene drawn from `tree_seed`.
    Written under a fixed partial name and renamed when whole."""
    from PIL import Image

    root = Path(root)
    partial = root.with_name(root.name + ".partial")
    if partial.exists():
        shutil.rmtree(partial)
    H, W = DTU_HW
    K = np.array([[0.9 * W, 0, W / 2], [0, 0.9 * W, H / 2], [0, 0, 1]],
                 np.float32)
    centers, radii, colors = sphere_scene(np.random.RandomState(tree_seed))
    exts = _dtu_grid()
    s = DTU_SCENE_SCALE
    views = [render_view(e, K, H, W, centers * s, radii * s, colors)
             for e in exts]
    cams = partial / "Cameras" / "train"
    cams.mkdir(parents=True)
    quarter = K.copy()
    quarter[:2] /= 4
    for i, e in enumerate(exts):
        mm = e.copy()
        mm[:3, 3] /= DTU_SCALE_FACTOR
        _write_mvsnet_cam(cams / f"{i:08d}_cam.txt", mm, quarter, 425.0, 2.5)
    images = partial / "Rectified" / "scan1_train"
    images.mkdir(parents=True)
    jobs = [(images / f"rect_{i + 1:03d}_{light}_r5000.png",
             (np.clip(rgb * (0.7 + 0.05 * light), 0, 1) * 255).astype(
                 np.uint8))
            for i, (rgb, _, _) in enumerate(views)
            for light in range(DTU_LIGHTS)]
    with ThreadPoolExecutor(threads) as pool:   # Pillow frees the GIL
        list(pool.map(lambda j: Image.fromarray(j[1]).save(j[0]), jobs))
    depths = partial / "Depths" / "scan1"
    depths.mkdir(parents=True)
    for i in DTU_SRC_CAMS:
        d = views[i][2][..., 0]
        stem = depths / f"depth_map_{i:04d}_TransMVSNet"
        # a PNG unit is 1e-4 of the reader's (TransMVSNet-scaled) depth
        Image.fromarray(np.round(d / 1e-4).astype(np.uint16)).save(
            stem.with_suffix(".png"))
        conf = np.where(d > 0, 0.9 - 0.3 * (d - d.min()) / np.ptp(d), 0)
        Image.fromarray(np.round(conf / 1e-4).astype(np.uint16)).save(
            stem.with_name(stem.name + "_conf.png"))
    (partial / "splits").mkdir()
    for split in ("train", "val"):
        (partial / "splits" / f"dtu_{split}_all.txt").write_text("scan1\n")
    os.replace(partial, root)
