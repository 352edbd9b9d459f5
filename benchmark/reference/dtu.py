"""DTU samples and batches, read again for the reference (a frozen copy of
the port's data/dtu.py, data/codecs.py and data/contract.py paths that a
training batch takes, with the 16-bit PNGs decoded by Pillow instead of the
port's own codec), and the order in which a shuffled BatchLoader yields
them."""

from __future__ import annotations

from itertools import product
from pathlib import Path

import numpy as np

SCALE_FACTOR_DEFAULT = 0.7 / 872.0
SRC_CAM_IDCS = [30, 10, 6, 35]
N_LIGHTS = 7
DEPTH_SCALE_FACTOR = 1e-4


def _read_rgb(path, downsample):
    from PIL import Image

    img = Image.open(path)
    if downsample and downsample != 1:
        w, h = img.size
        img = img.resize((int(w * downsample), int(h * downsample)))
    return np.asarray(img, np.float32)[..., :3] / 255.0


def _read_png16(path):
    from PIL import Image

    with Image.open(path) as img:
        arr = np.asarray(img)
    if arr.ndim != 2:
        raise ValueError(f"{path}: expected a grey PNG, got {arr.shape}")
    return arr.astype(np.uint16)


def nearest_resize(img, h, w):
    ys = (np.arange(h) * (img.shape[0] / h)).astype(np.int64)
    xs = (np.arange(w) * (img.shape[1] / w)).astype(np.int64)
    return img[ys][:, xs]


class DTUSamples:
    """The training samples of a DTU tree: scans x 49 cams x 7 lights."""

    def __init__(self, root, downsample: float = 0.5,
                 scale_factor: float = SCALE_FACTOR_DEFAULT):
        self.root = Path(root)
        self.downsample, self.sf = downsample, scale_factor
        self.scans = [ln.strip() for ln in (
            self.root / "splits" / "dtu_train_all.txt").read_text(
        ).splitlines() if ln.strip()]
        cam_dir = self.root / "Cameras" / "train"
        paths = sorted(p for p in cam_dir.iterdir()
                       if p.name.endswith("_cam.txt"))
        self.cam_ids, exts, Ks = [], [], []
        for p in paths:
            lines = [ln.rstrip() for ln in p.read_text().splitlines()]
            ext = np.array(" ".join(lines[1:5]).split(), np.float32).reshape(
                4, 4)
            K = np.array(" ".join(lines[7:10]).split(), np.float32).reshape(
                3, 3)
            K[:2] *= 4 * downsample
            ext[:3, 3] *= scale_factor
            self.cam_ids.append(int(p.name.replace("_cam.txt", "")))
            exts.append(ext)
            Ks.append(K)
        self.extrinsics, self.intrinsics = np.stack(exts), np.stack(Ks)
        self.metas = list(product(range(len(self.scans)),
                                  range(len(self.cam_ids)), range(N_LIGHTS)))
        self.znear, self.zfar = 400 * scale_factor, 1500 * scale_factor

    def __len__(self):
        return len(self.metas)

    def _depth(self, scan, cam_id):
        path = (self.root / "Depths" / scan
                / f"depth_map_{cam_id:04d}_TransMVSNet.png")
        d = (_read_png16(path).astype(np.float32) * DEPTH_SCALE_FACTOR
             / SCALE_FACTOR_DEFAULT)
        conf = (_read_png16(path.with_name(path.name.replace(
            ".png", "_conf.png"))).astype(np.float32) * DEPTH_SCALE_FACTOR)
        h, w = int(512 * self.downsample), int(640 * self.downsample)
        if self.downsample != 1:
            d, conf = nearest_resize(d, h, w), nearest_resize(conf, h, w)
        std = ((-2.5679e-2 * conf + 3.2818e-2)
               * (self.sf / SCALE_FACTOR_DEFAULT))
        return (d * self.sf)[..., None], (d > 0).astype(np.float32)[..., None], \
            std[..., None]

    def __getitem__(self, idx):
        scan_idx, cam_idx, light = self.metas[idx]
        scan = self.scans[scan_idx]
        idcs = [cam_idx] + SRC_CAM_IDCS
        ids = [self.cam_ids[i] for i in idcs]
        imgs = [_read_rgb(self.root / "Rectified" / f"{scan}_train"
                          / f"rect_{i + 1:03d}_{light}_r5000.png",
                          self.downsample) for i in ids]
        priors = [self._depth(scan, c) for c in ids[1:]]
        return {
            "target_rgb": imgs[0],
            "target_alpha": np.ones_like(imgs[0][..., :1]),
            "target_extrinsics": self.extrinsics[idcs[0]],
            "target_intrinsics": self.intrinsics[idcs[0]],
            "src_rgbs": np.stack(imgs[1:]),
            "src_alphas": np.stack([m for _, m, _ in priors]),
            "src_depths": np.stack([d for d, _, _ in priors]),
            "src_depth_stds": np.stack([s for _, _, s in priors]),
            "src_extrinsics": self.extrinsics[idcs[1:]],
            "src_intrinsics": self.intrinsics[idcs[1:]],
        }


def collate(samples):
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def shuffled_batches(n: int, batch_size: int, seed: int, n_batches: int):
    """The sample indices of a shuffled loader's first `n_batches` batches:
    each epoch a numpy RandomState(seed + epoch) permutation, the last
    partial batch dropped."""
    out, epoch = [], 0
    while len(out) < n_batches:
        idcs = np.arange(n)
        np.random.RandomState(seed + epoch).shuffle(idcs)
        out += [idcs[b * batch_size:(b + 1) * batch_size]
                for b in range(n // batch_size)]
        epoch += 1
    return out[:n_batches]
