"""MultiFace dataset: cross-dataset evaluation of FaceScape checkpoints (port
of diner_tpu.data.multiface; the same semantics and meta cache).

KRT camera files; Meta's gamma correction (gamma 2.0, black 3/255,
per-channel scale [1.4, 1.1, 1.6] / 1.1); an integer `downsample` with /32
alignment and the intrinsics rescaled; white background where alpha < 1;
extrinsics mm -> m; reference views nearest the split's `ref_centers` with
a 10 cm frustum tolerance; sigma 1e-3 when there are no conf files, else
FaceScape's conf2std clipped >= 0, 0 where depth == 0; znear/zfar =
0.5/1.5 m; the cam sweep slerps rotation and location through the source
poses in a closed loop.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
from scipy.spatial.transform import Rotation

from diner_tpu_torch.data.codecs import (DEPTH_SCALE_FACTOR, nearest_resize,
                                         read_png16)
from diner_tpu_torch.data.contract import validate_sample
from diner_tpu_torch.geometry.slerp import PoseSlerp


def gamma_correct(img, dim: int = -1):
    """Meta's MultiFace colour transfer; img in [0, 1]."""
    img = np.asarray(img, np.float32)
    gamma, black = 2.0, 3.0 / 255.0
    shape = [3 if i == dim % img.ndim else 1 for i in range(img.ndim)]
    scale = np.array([1.4, 1.1, 1.6], np.float32).reshape(shape)
    img = img * scale / 1.1
    return np.clip((1.0 / (1 - black) * 0.95 * np.clip(img - black, 0, 2))
                   ** (1.0 / gamma) - 15.0 / 255.0, 0, 2)


def load_krt(path):
    """Parse a MultiFace KRT camera file: per camera its name, K (3 lines),
    distortion (1), [R|t] (3) and a blank line."""
    cameras = {}
    with open(path) as f:
        while True:
            name = f.readline()
            if name == "":
                break
            intrin = [[float(x) for x in f.readline().split()]
                      for _ in range(3)]
            dist = [float(x) for x in f.readline().split()]
            extrin = [[float(x) for x in f.readline().split()]
                      for _ in range(3)]
            f.readline()
            cameras[name.strip()] = {"intrin": np.array(intrin),
                                     "dist": np.array(dist),
                                     "extrin": np.array(extrin)}
    return cameras


def _bilinear_resize(img, h, w):
    from PIL import Image

    if img.ndim == 2:
        return np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))
    return np.asarray(Image.fromarray(
        (np.clip(img, 0, 1) * 255).astype(np.uint8)).resize((w, h),
                                                            Image.BILINEAR),
        np.float32) / 255.0


class MultiFaceDataset:
    znear = 0.5
    zfar = 1.5

    def __init__(self, root, stage: str = "val", downsample: int = 8,
                 split_config=None, depth_suffix: str = ".png",
                 depth_std_suffix=None, subject_filter=None,
                 sequence_filter=None, target_filter=None,
                 manual_target_params=None, meta_dir=None):
        self.data_dir = Path(root)
        if not self.data_dir.exists():
            raise FileNotFoundError(root)
        if not isinstance(downsample, int):
            raise TypeError(f"downsample must be an int, got {downsample!r}")
        self.stage = stage
        self._krt_cache = {}
        self.downsample = downsample
        self.depth_suffix = depth_suffix
        self.depth_std_suffix = depth_std_suffix
        self.meta_dir = Path(meta_dir) if meta_dir else (
            Path(__file__).resolve().parents[2] / "assets" / "data_splits"
            / "multiface")
        self.split_config = Path(split_config) if split_config else (
            self.meta_dir / "tiny_subset.json")
        self.metas = self.get_metas(subject_filter, sequence_filter,
                                    target_filter)
        if manual_target_params is None:
            self.manual_target_params = None
        else:
            self.manual_target_params = json.loads(
                Path(manual_target_params).read_text())
            if len(self.manual_target_params["extrinsics"]) != len(self):
                raise ValueError("manual_target_params needs one target per "
                                 "meta")

    @staticmethod
    def read_img(path):
        from PIL import Image

        rgb = np.asarray(Image.open(path), np.float32)[..., :3] / 255.0
        return np.clip(gamma_correct(rgb, dim=-1), 0, 1).astype(np.float32)

    @staticmethod
    def read_alpha(path):
        from PIL import Image

        a = np.asarray(Image.open(path), np.float32) / 255.0
        if a.ndim == 3:
            a = a[..., 0]
        return a[..., None]

    @staticmethod
    def read_depth(path):
        return (read_png16(path).astype(np.float32)
                * DEPTH_SCALE_FACTOR)[..., None]

    def get_metas(self, subject_filter=None, sequence_filter=None,
                  target_filter=None):
        meta_fpath = self.meta_dir / f"{self.stage}_{self.split_config.stem}.txt"
        if meta_fpath.exists():
            metas = json.loads(meta_fpath.read_text())
        else:
            metas = self._generate_metas()
            meta_fpath.parent.mkdir(parents=True, exist_ok=True)
            meta_fpath.write_text(json.dumps(metas, indent="\t"))
        if subject_filter is not None:
            metas = [m for m in metas
                     if any(s in m["scan_path"] for s in subject_filter)]
        if sequence_filter is not None:
            metas = [m for m in metas
                     if any(s in m["scan_path"] for s in sequence_filter)]
        if target_filter is not None:
            metas = [m for m in metas
                     if any(t == m["target_id"] for t in target_filter)]
        return metas

    def _krt(self, subject):
        """The subject's KRT, parsed once: __getitem__ runs in the loader's
        thread pool (a dict assignment is atomic; a rare second parse is
        harmless)."""
        krt = self._krt_cache.get(subject)
        if krt is None:
            krt = load_krt(self.data_dir / subject / "KRT")
            self._krt_cache[subject] = krt
        return krt

    def _generate_metas(self):
        split = json.loads(self.split_config.read_text())
        split = split["train"] if self.stage == "train" else split["val"]
        metas, sample_idx = [], 0
        for subj in split["subjects"]:
            krt = load_krt(self.data_dir / subj / "KRT")
            names = np.array(sorted(krt.keys()))
            ext = np.array([krt[n]["extrin"] for n in names])
            centers = -np.einsum("nji,nj->ni", ext[:, :3, :3], ext[:, :3, 3])
            dirs = ext[:, 2, :3]

            origin = np.array([[0, 0, 1000.0]])
            ideal = np.array(split["ref_centers"], np.float64).reshape(-1, 3)
            if subj == "m--20190529--1004--5067077--GHS":  # calibration fix
                b = np.pi * 4 / 6
                rot_y = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                                  [-np.sin(b), 0, np.cos(b)]])
                ideal = (rot_y @ (ideal - origin).T).T + origin

            dists = np.linalg.norm(ideal[:, None] - centers[None], axis=-1)
            ref_idcs = np.argsort(dists, axis=1)[:, 0]
            ref_centers, ref_dirs = centers[ref_idcs], dirs[ref_idcs]
            ref_names = names[ref_idcs].tolist()

            normals = np.cross(
                ref_centers[[0, 1, 2, 3]] - ref_centers[[1, 2, 3, 0]],
                ref_dirs[[0, 1, 2, 3]] + ref_dirs[[1, 2, 3, 0]])
            normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
            inside = np.sum((centers[None] - ref_centers[:, None])
                            * normals[:, None], axis=-1)
            inside = np.all(inside > -100, axis=0)  # 10 cm tolerance (mm)
            inside[ref_idcs] = False
            targets = names[inside].tolist()

            seq_paths = [p for p in
                         sorted((self.data_dir / subj / "images").iterdir())
                         if p.name in split["sequences"]]
            for seq_path in seq_paths:
                for target in targets:
                    for frame in sorted((seq_path / target).iterdir()):
                        metas.append(dict(
                            idx=sample_idx,
                            scan_path=str(frame.relative_to(self.data_dir)),
                            target_id=target, ref_ids=ref_names))
                        sample_idx += 1
        return metas

    def __len__(self):
        return len(self.metas)

    def _dpath(self, p: Path):
        return p.parents[3] / "depths" / p.relative_to(p.parents[2]).parent / (
            p.stem + self.depth_suffix)

    def _dstdpath(self, p: Path):
        return p.parents[3] / "depths" / p.relative_to(p.parents[2]).parent / (
            p.stem + self.depth_std_suffix)

    @staticmethod
    def _apath(p: Path):
        return p.parents[3] / "masks" / p.relative_to(p.parents[2])

    def __getitem__(self, idx):
        meta = self.metas[idx]
        source_ids = meta["ref_ids"]
        target_id = meta["target_id"]
        scan_path = Path(meta["scan_path"])
        subject = scan_path.parents[3].name
        seq = scan_path.parents[1].name
        frame = scan_path.stem

        tgt_img_path = self.data_dir / scan_path
        src_img_paths = [self.data_dir / subject / "images" / seq / sid /
                         f"{frame}.png" for sid in source_ids]

        target_rgb = self.read_img(tgt_img_path)
        target_alpha = self.read_alpha(self._apath(tgt_img_path))
        src_rgbs, src_alphas, src_depths, src_stds = [], [], [], []
        for p in src_img_paths:
            src_rgbs.append(self.read_img(p))
            src_alphas.append(self.read_alpha(self._apath(p)))
            d = self.read_depth(self._dpath(p))
            if self.depth_std_suffix is None:
                s = np.full_like(d, 1e-3)
            else:
                s = np.clip(-1.582e-2 * self.read_depth(self._dstdpath(p))
                            + 1.649e-2, 0, None)
            s[d == 0] = 0
            src_depths.append(d)
            src_stds.append(s)

        src_rgbs = np.stack(src_rgbs)
        src_alphas = np.stack(src_alphas)
        src_depths = np.stack(src_depths)
        src_stds = np.stack(src_stds)

        # white background
        src_rgbs = np.where(src_alphas < 1, 1.0, src_rgbs).astype(np.float32)
        target_rgb = np.where(target_alpha < 1, 1.0,
                              target_rgb).astype(np.float32)

        krt = self._krt(subject)
        if self.manual_target_params is None:
            tgt_ext = np.asarray(krt[target_id]["extrin"], np.float32)
            tgt_K = np.asarray(krt[target_id]["intrin"], np.float32)
        else:
            tgt_ext = np.asarray(self.manual_target_params["extrinsics"][idx],
                                 np.float32)[:3]
            tgt_K = np.asarray(self.manual_target_params["intrinsics"][idx],
                               np.float32)
        src_ext = np.asarray([krt[s]["extrin"] for s in source_ids],
                             np.float32)
        src_K = np.asarray([krt[s]["intrin"] for s in source_ids], np.float32)

        def to_h(e):
            out = np.eye(4, dtype=np.float32)
            out[:3] = e
            return out

        tgt_ext = to_h(tgt_ext)
        src_ext = np.stack([to_h(e) for e in src_ext])
        tgt_ext[:3, 3] /= 1000.0  # mm -> m
        src_ext[:, :3, 3] /= 1000.0

        H, W = target_rgb.shape[:2]
        h = int((H / self.downsample) // 32 * 32)
        w = int((W / self.downsample) // 32 * 32)
        if (h, w) != (H, W):
            target_rgb = _bilinear_resize(target_rgb, h, w)
            src_rgbs = np.stack([_bilinear_resize(r, h, w) for r in src_rgbs])
            target_alpha = nearest_resize(target_alpha, h, w)
            src_alphas = np.stack([nearest_resize(a, h, w)
                                   for a in src_alphas])
            if src_depths.shape[1:3] != (h, w):
                src_depths = np.stack([nearest_resize(d, h, w)
                                       for d in src_depths])
                src_stds = np.stack([nearest_resize(s, h, w)
                                     for s in src_stds])
            tgt_K = tgt_K.copy()
            tgt_K[0] *= w / W
            tgt_K[1] *= h / H
            src_K = src_K.copy()
            src_K[:, 0] *= w / W
            src_K[:, 1] *= h / H

        sample = {
            "target_rgb": target_rgb,
            "target_alpha": target_alpha,
            "target_extrinsics": tgt_ext,
            "target_intrinsics": tgt_K,
            "src_rgbs": src_rgbs,
            "src_alphas": src_alphas,
            "src_depths": src_depths,
            "src_depth_stds": src_stds,
            "src_extrinsics": src_ext,
            "src_intrinsics": src_K,
            "sample_name": f"{subject}-{seq}-{frame}-{target_id}-"
                           f"{'-'.join(source_ids)}",
            "frame": frame,
            "target_view_id": int(target_id),
            "src_view_ids": np.asarray([int(s) for s in source_ids]),
        }
        validate_sample(sample)
        return sample

    def get_cam_sweep_extrinsics(self, nframes, scan_idx, **_):
        """A closed loop of rotation and location slerps through the source
        poses."""
        base = self.__getitem__(scan_idx)
        poses = np.linalg.inv(base["src_extrinsics"].astype(np.float64))
        rots = Rotation.from_matrix(
            np.concatenate([poses[:, :3, :3], poses[[0], :3, :3],
                            poses[[2], :3, :3]]))
        locs = np.concatenate([poses[:, :3, 3], poses[[0], :3, 3],
                               poses[[2], :3, 3]])
        times = np.linspace(0, 1, len(locs))
        slerp = PoseSlerp(times, rots, locs)
        target_poses = np.tile(np.eye(4), (nframes, 1, 1))
        r, l = slerp(np.linspace(0, 1, nframes + 1)[:-1])
        target_poses[:, :3, :3] = r.as_matrix()
        target_poses[:, :3, 3] = l
        return np.linalg.inv(target_poses).astype(np.float32)
