"""DTU dataset: a fixed 49-camera grid, 7 lights, TransMVSNet depth priors
(port of diner_tpu.data.dtu; the same on-disk layout and constants):
  - Rectified/<scan>_train/rect_{cam+1:03d}_{light}_r5000.png images,
  - Cameras/train/*_cam.txt MVSNet cams (intrinsics stored at 1/4 res -> x4,
    then x downsample; translations x scale_factor),
  - Depths/<scan>/depth_map_{cam:04d}_<depth_fname>.png uint16 (1e-4 m,
    un-scaled by the TransMVSNet training factor 0.7/872) or GT .pfm
    (resize 1/2 nearest, crop to 512x640),
  - conf files *_conf.png -> sigma via conf2std(c) = -2.5679e-2 c + 3.2818e-2,
  - scale_factor 0.7/872 unifies DTU mm with FaceScape meters,
  - znear/zfar = 400/1500 x sf, fixed source views [30, 10, 6, 35],
  - metas = scans x 49 cams x 7 lights; split lists in assets/data_splits/dtu.
Samples follow data/contract.py. RGB decoding and resizing go through
Pillow, as the JAX reader's do, so that they agree bitwise.
"""

from __future__ import annotations

from itertools import product
from pathlib import Path

import numpy as np
import torch
from scipy.spatial.transform import Rotation, Slerp as RotSlerp

from diner_tpu_torch.data.codecs import (DEPTH_SCALE_FACTOR, nearest_resize,
                                         read_pfm, read_png16)
from diner_tpu_torch.data.contract import validate_sample
from diner_tpu_torch.geometry.cameras import invert_pose, ray_closest_points

ASSETS = Path(__file__).resolve().parents[2] / "assets" / "data_splits" / "dtu"


def _read_rgb(path, downsample):
    from PIL import Image

    img = Image.open(path)
    if downsample and downsample != 1:
        w, h = img.size
        img = img.resize((int(w * downsample), int(h * downsample)))
    arr = np.asarray(img, np.float32) / 255.0
    return arr[..., :3]


class DTUDataset:
    SCALE_FACTOR_DEFAULT = 0.7 / 872.0
    SRC_CAM_IDCS = [30, 10, 6, 35]
    N_LIGHTS = 7

    def __init__(self, root, stage: str = "train",
                 scale_factor: float = SCALE_FACTOR_DEFAULT,
                 downsample: float = 0.5, depth_fname: str = "TransMVSNet",
                 split_dir=None):
        self.data_dir = Path(root)
        if not self.data_dir.exists():
            raise FileNotFoundError(root)
        self.stage = stage
        self.scale_factor = scale_factor
        self.downsample = downsample
        self.depth_fname = depth_fname
        self.split_dir = Path(split_dir) if split_dir else ASSETS

        self.scan_list = self._scan_list()
        self.cam_ids, self.extrinsics, self.intrinsics = self._load_cams()
        self.znear = 400 * scale_factor
        self.zfar = 1500 * scale_factor
        self.metas = [
            dict(scan_idx=s, cam_idx=c, light_idx=l)
            for s, c, l in product(range(len(self.scan_list)),
                                   range(len(self.cam_ids)),
                                   range(self.N_LIGHTS))]

    @staticmethod
    def conf2std(conf):
        """The reference's calibration of sigma from the MVS confidence."""
        return -2.5679e-2 * conf + 3.2818e-2

    def _scan_list(self):
        fname = {"train": "dtu_train_all.txt",
                 "val": "dtu_val_all.txt"}[self.stage]
        return [ln.strip() for ln in
                (self.split_dir / fname).read_text().splitlines()
                if ln.strip()]

    def _load_cams(self):
        cam_dir = self.data_dir / "Cameras" / "train"
        paths = sorted(p for p in cam_dir.iterdir()
                       if p.name.endswith("_cam.txt"))
        ids, exts, Ks = [], [], []
        for p in paths:
            lines = [ln.rstrip() for ln in p.read_text().splitlines()]
            ext = np.fromstring(" ".join(lines[1:5]), dtype=np.float32,
                                sep=" ").reshape(4, 4)
            K = np.fromstring(" ".join(lines[7:10]), dtype=np.float32,
                              sep=" ").reshape(3, 3)
            K[:2] *= 4  # stored at quarter resolution
            K[:2] *= self.downsample
            ext[:3, 3] *= self.scale_factor
            ids.append(int(p.name.replace("_cam.txt", "")))
            exts.append(ext)
            Ks.append(K)
        return ids, np.stack(exts), np.stack(Ks)

    def __len__(self):
        return len(self.metas)

    def _depth_path(self, scan_name, cam_id):
        return (self.data_dir / "Depths" / scan_name /
                f"depth_map_{cam_id:04d}_{self.depth_fname}.png")

    def _read_depth(self, path):
        """-> (depth (H, W, 1) scaled-metric, mask (H, W, 1)); 512x640 base."""
        path = Path(path)
        if path.suffix == ".pfm":
            d, _ = read_pfm(path)
            h, w = d.shape[0] // 2, d.shape[1] // 2
            d = nearest_resize(d, h, w)[44:556, 80:720]
        elif path.suffix == ".png":
            d = read_png16(path).astype(np.float32) * DEPTH_SCALE_FACTOR
            d /= self.SCALE_FACTOR_DEFAULT  # undo TransMVSNet training scaling
        else:
            raise ValueError(path)
        if d.shape != (512, 640):
            raise ValueError(f"{path}: depth map of shape {d.shape}, "
                             f"expected (512, 640)")
        if self.downsample != 1:
            d = nearest_resize(d, int(512 * self.downsample),
                               int(640 * self.downsample))
        mask = (d > 0).astype(np.float32)
        d = d * self.scale_factor
        return d[..., None], mask[..., None]

    def __getitem__(self, idx):
        meta = self.metas[idx]
        scan_name = self.scan_list[meta["scan_idx"]]
        light = meta["light_idx"]
        all_idcs = [meta["cam_idx"]] + self.SRC_CAM_IDCS
        all_ids = [self.cam_ids[i] for i in all_idcs]

        imgs = [
            _read_rgb(self.data_dir / "Rectified" / f"{scan_name}_train" /
                      f"rect_{i + 1:03d}_{light}_r5000.png", self.downsample)
            for i in all_ids]
        depths, masks, stds = [], [], []
        for cam_id in all_ids[1:]:
            dp = self._depth_path(scan_name, cam_id)
            d, m = self._read_depth(dp)
            # conf is a unitless score: read it raw (x DEPTH_SCALE_FACTOR
            # only), then scale the resulting sigma into the configured
            # world scale. At the default scale_factor this equals the
            # reference's routing of conf through its depth reader, where
            # the two factors cancel; at any other scale_factor that routing
            # would corrupt conf ~1000x, while here sigma stays proportional
            # to the scene scale.
            conf = read_png16(dp.parent / dp.name.replace(
                ".png", "_conf.png")).astype(np.float32) * DEPTH_SCALE_FACTOR
            if self.downsample != 1:
                conf = nearest_resize(conf, int(512 * self.downsample),
                                      int(640 * self.downsample))
            depths.append(d)
            masks.append(m)
            stds.append(self.conf2std(conf[..., None])
                        * (self.scale_factor / self.SCALE_FACTOR_DEFAULT))

        sample = {
            "target_rgb": imgs[0],
            "target_alpha": np.ones_like(imgs[0][..., :1]),
            "target_extrinsics": self.extrinsics[all_idcs[0]],
            "target_intrinsics": self.intrinsics[all_idcs[0]],
            "src_rgbs": np.stack(imgs[1:]),
            "src_alphas": np.stack(masks),
            "src_depths": np.stack(depths),
            "src_depth_stds": np.stack(stds),
            "src_extrinsics": self.extrinsics[all_idcs[1:]],
            "src_intrinsics": self.intrinsics[all_idcs[1:]],
            "sample_name": f"{scan_name}-{all_ids[0]}",
            "target_view_id": all_ids[0],
            "src_view_ids": np.asarray(all_ids[1:]),
            "light_idx": light,
            "scan_idx": meta["scan_idx"],
        }
        validate_sample(sample)
        return sample

    def check_depth_existence(self):
        """Raise FileNotFoundError listing every missing depth or
        confidence file of the source views (__getitem__ reads both)."""
        missing = []
        for meta in self.metas:
            scan_name = self.scan_list[meta["scan_idx"]]
            for i in self.SRC_CAM_IDCS:
                p = self._depth_path(scan_name, self.cam_ids[i])
                for f in (p, p.with_name(p.name.replace(".png", "_conf.png"))):
                    if not f.exists():
                        missing.append(f)
        if missing:
            raise FileNotFoundError("Missing depth files", missing)

    def get_cam_sweep_extrinsics(self, nframes, scan_idx=None):
        """A spherical arc through cams 11 -> 24 -> 18 around the point
        nearest their optical axes; the poses and the closest points in
        float32, as the JAX reader computes them."""
        poses = invert_pose(torch.from_numpy(
            self.extrinsics[[11, 24, 18]])).numpy()
        left, center, right = poses
        rays = [torch.from_numpy(np.concatenate([p[:3, 3], p[:3, 2]]))
                for p in (left, center, right)]
        pts = []
        for a, b in ((rays[0], rays[1]), (rays[1], rays[2]),
                     (rays[0], rays[2])):
            x1, x2 = ray_closest_points(a, b)
            pts += [x1.numpy(), x2.numpy()]
        origin = np.mean(pts, axis=0)
        radius = np.mean([np.linalg.norm(origin - p[:3, 3]) for p in poses])

        t = np.linspace(0, 1, nframes)
        xs = [(p[:3, 3] - origin) / np.linalg.norm(p[:3, 3] - origin)
              for p in poses]
        th1 = np.arccos(np.clip(xs[0] @ xs[1], -1, 1))
        th2 = np.arccos(np.clip(xs[1] @ xs[2], -1, 1))
        centers = np.zeros((nframes, 3), np.float64)
        first = t < 0.5
        t1 = t[first] * 2
        t2 = t[~first] * 2 - 1
        centers[first] = (np.sin((1 - t1[:, None]) * th1) / np.sin(th1) * xs[0]
                          + np.sin(t1[:, None] * th1) / np.sin(th1) * xs[1])
        centers[~first] = (np.sin((1 - t2[:, None]) * th2) / np.sin(th2) * xs[1]
                           + np.sin(t2[:, None] * th2) / np.sin(th2) * xs[2])
        centers = centers * radius + origin

        slerp = RotSlerp([0.0, 0.5, 1.0], Rotation.from_matrix(
            np.stack([p[:3, :3] for p in poses])))
        rots = slerp(t).as_matrix()
        target_poses = np.tile(np.eye(4, dtype=np.float64), (nframes, 1, 1))
        target_poses[:, :3, :3] = rots
        target_poses[:, :3, 3] = centers
        return np.linalg.inv(target_poses).astype(np.float32)
