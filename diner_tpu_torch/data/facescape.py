"""FaceScape dataset: 4-view human-head novel-view synthesis (port of
diner_tpu.data.facescape; the same disk layout, metas and meta cache).

Layout: <subject>/<expression 01..20>/view_XXXXX/{rgba_colorcalib.png,
depth_TransMVSNet.png, *_conf.png} and a cameras.json per scan. Meta
generation: for each scan, pick the 4 cameras nearest the ideal corner
directions (azimuth +-range_hor, elevation +-range_vert), rotated ("slid")
around z in slide_step steps over +-slide_range; target views must lie
inside the frustum spanned by the 4 reference directions; scans whose
frontal min depth > 2 m are rejected; conf2std sigma = -1.582e-2 c +
1.649e-2; white background where alpha < 0.5; znear/zfar = 1.0/2.5 m.
The metas are cached in meta_dir under the JAX reader's file name and JSON,
so that either package reads the other's cache.
"""

from __future__ import annotations

import hashlib
import json
import threading
from itertools import product
from pathlib import Path

import numpy as np

from diner_tpu_torch.data.codecs import DEPTH_SCALE_FACTOR, read_png16
from diner_tpu_torch.data.contract import validate_sample


def _read_rgba(path, bg=1.0):
    from PIL import Image

    arr = np.asarray(Image.open(path), np.float32) / 255.0
    rgb, a = arr[..., :3].copy(), arr[..., 3:4]
    rgb[a[..., 0] < 0.5] = bg
    return rgb, a


def _read_depth(path):
    return (read_png16(path).astype(np.float32) * DEPTH_SCALE_FACTOR)[..., None]


def _to_h(trafo):
    out = np.eye(4, dtype=np.float32)
    out[:3, :4] = np.asarray(trafo, np.float32)[:3, :4]
    return out


class FacescapeDataset:
    znear = 1.0
    zfar = 2.5
    RGBA_FNAME = "rgba_colorcalib.png"
    DEPTH_FNAME = "depth_TransMVSNet.png"

    def __init__(self, root, stage: str = "train", range_hor: float = 45,
                 range_vert: float = 30, slide_range: float = 40,
                 slide_step: float = 20.0, random_ref_views: bool = False,
                 depth_fname=None, meta_dir=None, val_subjects=None, seed=0):
        self.data_dir = Path(root)
        if not self.data_dir.exists():
            raise FileNotFoundError(root)
        self.stage = stage
        self.range_hor = range_hor
        self.range_vert = range_vert
        self.nsource = 4
        self.slide_range = slide_range
        self.slide_step = slide_step
        self.random_ref_views = random_ref_views
        self.seed = seed
        self._visits = {}
        self._rng_lock = threading.Lock()
        if depth_fname:
            self.DEPTH_FNAME = depth_fname
        self.DEPTH_STD_FNAME = self.DEPTH_FNAME.replace(".png", "_conf.png")
        self.meta_dir = Path(meta_dir) if meta_dir else (
            Path(__file__).resolve().parents[2] / "assets" / "data_splits"
            / "facescape")
        self._val_subjects = val_subjects
        self.metas = self.get_metas()

    @staticmethod
    def conf2std(conf):
        return -1.582e-2 * conf + 1.649e-2

    @staticmethod
    def int_to_viewdir(i: int) -> str:
        return f"view_{i:05d}"

    def _meta_path(self):
        # every parameter that changes _generate_metas' output shows up in
        # the cache name, or a changed parameter would reuse stale metas;
        # non-default slide_step, depth_fname and val_subjects add a short
        # digest (the defaults keep the names of the shipped split files)
        name = (f"{self.stage}_{self.range_hor}_{self.range_vert}"
                + (f"_{self.slide_range}" if self.slide_range != 0 else ""))
        extras = (self.slide_step, self.DEPTH_FNAME,
                  tuple(self._val_subjects) if self._val_subjects else None)
        if extras != (20.0, "depth_TransMVSNet.png", None):
            digest = hashlib.sha1(repr(extras).encode()).hexdigest()[:8]
            name += f"_{digest}"
        return self.meta_dir / (name + ".txt")

    def get_metas(self):
        meta_fpath = self._meta_path()
        if meta_fpath.exists():
            return json.loads(meta_fpath.read_text())
        metas = self._generate_metas()
        meta_fpath.parent.mkdir(parents=True, exist_ok=True)
        meta_fpath.write_text(json.dumps(metas, indent="\t"))
        return metas

    def _subjects(self):
        if self._val_subjects is not None:
            val = list(self._val_subjects)
        else:
            lst = self.meta_dir / "publishable_list_v1.txt"
            val = [f"{int(i):03d}" for i in
                   np.loadtxt(lst, delimiter=",").astype(int)] \
                if lst.exists() else []
        train = sorted(d.name for d in self.data_dir.iterdir()
                       if d.is_dir() and d.name not in val)
        return train if self.stage == "train" else val

    def _generate_metas(self):
        range_hor_rd = self.range_hor / 180 * np.pi
        range_vert_rd = self.range_vert / 180 * np.pi
        metas = []
        sample_idx = 0
        scans = [self.data_dir / s / f"{p:02d}"
                 for s, p in product(self._subjects(), range(1, 21))]
        for scan in scans:
            try:
                cam_path = scan / "cameras.json"
                if not cam_path.exists():
                    continue
                cam_dict = json.loads(cam_path.read_text())
                cam_ids = np.array(sorted(cam_dict.keys()))
                cam_ids = np.array([
                    i for i in cam_ids
                    if (scan / self.int_to_viewdir(int(i))
                        / self.RGBA_FNAME).exists()
                    and (scan / self.int_to_viewdir(int(i))
                         / self.DEPTH_FNAME).exists()
                    and _read_depth(scan / self.int_to_viewdir(int(i))
                                    / self.DEPTH_FNAME).max() <= self.zfar])
                if len(cam_ids) < self.nsource + 1:
                    continue

                extrinsics = np.array([cam_dict[k]["extrinsics"]
                                       for k in cam_ids], np.float32)
                centers = -np.einsum("nji,nj->ni", extrinsics[:, :3, :3],
                                     extrinsics[:, :3, 3])
                cam_dirs = centers / np.linalg.norm(centers, axis=-1,
                                                    keepdims=True)
                ideal = np.array([[np.sin(az) * np.cos(el),
                                   -np.cos(az) * np.cos(el),
                                   np.sin(el)]
                                  for az, el in product(
                                      [-range_hor_rd, range_hor_rd],
                                      [-range_vert_rd, range_vert_rd])])

                # reject misaligned scans: frontal min depth > 2 m
                frontal = cam_ids[np.argmax(cam_dirs
                                            @ np.array([0.0, -1.0, 0.0]))]
                d = _read_depth(scan / self.int_to_viewdir(int(frontal))
                                / self.DEPTH_FNAME)
                if d[d != 0].min() > 2:
                    continue

                for slide_angle in np.arange(-self.slide_range,
                                             self.slide_range + 1,
                                             self.slide_step):
                    sa = slide_angle / 180 * np.pi
                    rot = np.array([[np.cos(sa), -np.sin(sa), 0],
                                    [np.sin(sa), np.cos(sa), 0], [0, 0, 1.0]])
                    slid = (rot @ ideal.T).T
                    cosd = slid @ cam_dirs.T  # (Nref, N)
                    ref_idcs = np.argsort(cosd, axis=1)[:, ::-1][:, :4]
                    ref_ids = cam_ids[ref_idcs].tolist()

                    corners = cam_dirs[ref_idcs[:, 0]]
                    normals = np.stack([np.cross(corners[1], corners[0]),
                                        np.cross(corners[3], corners[1]),
                                        np.cross(corners[2], corners[3]),
                                        np.cross(corners[0], corners[2])])
                    inside = np.all(cam_dirs @ normals.T >= 0, axis=-1)
                    for tid in cam_ids[inside].tolist():
                        if tid in [r[0] for r in ref_ids]:
                            continue
                        metas.append(dict(
                            idx=sample_idx,
                            scan_path=str(scan.relative_to(self.data_dir)),
                            target_id=tid, ref_ids=ref_ids))
                        sample_idx += 1
            except Exception as e:  # an unreadable scan is skipped
                print("facescape meta generation: skipping", scan, e)
        return metas

    def check_depth_existence(self):
        """Raise FileNotFoundError listing every missing depth or
        depth-std file of every candidate reference view (random_ref_views
        may draw any of them)."""
        missing, seen = [], set()
        for meta in self.metas:
            scan_path = self.data_dir / meta["scan_path"]
            src_ids = {int(i) for row in meta["ref_ids"] for i in row}
            for sid in src_ids:
                vdir = scan_path / self.int_to_viewdir(sid)
                for fname in (self.DEPTH_FNAME, self.DEPTH_STD_FNAME):
                    p = vdir / fname
                    if p in seen:
                        continue
                    seen.add(p)
                    if not p.exists():
                        missing.append(p)
        if missing:
            raise FileNotFoundError("Missing depth files", missing)

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx):
        meta = self.metas[idx]
        target_id = meta["target_id"]
        if self.random_ref_views:
            # a private RandomState per (seed, idx, visit): the loader calls
            # __getitem__ from a thread pool, and a shared RandomState is
            # neither thread-safe nor reproducible under thread scheduling
            with self._rng_lock:
                visit = self._visits.get(idx, 0)
                self._visits[idx] = visit + 1
            rng = np.random.RandomState(
                (self.seed * 0x9E3779B1 + idx * 0x85EBCA77 + visit)
                % (2 ** 32))
            # never draw the target itself as a source view: a ref row holds
            # the top-4 cams of its corner and can contain it
            source_ids = []
            for s in meta["ref_ids"]:
                cand = [i for i in s if i != target_id] or s[:1]
                # an index draw keeps the metas' id type (cameras.json's key)
                source_ids.append(cand[int(rng.randint(len(cand)))])
        else:
            source_ids = [s[0] for s in meta["ref_ids"]]
        scan_path = self.data_dir / meta["scan_path"]
        frame, subject = scan_path.name, scan_path.parent.name

        cam_dict = json.loads((scan_path / "cameras.json").read_text())
        tgt_dir = scan_path / self.int_to_viewdir(int(target_id))
        target_rgb, target_alpha = _read_rgba(tgt_dir / self.RGBA_FNAME)

        src_rgbs, src_alphas, src_depths, src_stds = [], [], [], []
        for sid in source_ids:
            sdir = scan_path / self.int_to_viewdir(int(sid))
            rgb, a = _read_rgba(sdir / self.RGBA_FNAME)
            src_rgbs.append(rgb)
            src_alphas.append(a)
            src_depths.append(_read_depth(sdir / self.DEPTH_FNAME))
            src_stds.append(self.conf2std(
                _read_depth(sdir / self.DEPTH_STD_FNAME)))

        sample = {
            "target_rgb": target_rgb,
            "target_alpha": target_alpha,
            "target_extrinsics": _to_h(cam_dict[target_id]["extrinsics"]),
            "target_intrinsics": np.asarray(cam_dict[target_id]["intrinsics"],
                                            np.float32),
            "src_rgbs": np.stack(src_rgbs),
            "src_alphas": np.stack(src_alphas),
            "src_depths": np.stack(src_depths),
            "src_depth_stds": np.stack(src_stds),
            "src_extrinsics": np.stack([_to_h(cam_dict[s]["extrinsics"])
                                        for s in source_ids]),
            "src_intrinsics": np.stack([np.asarray(cam_dict[s]["intrinsics"],
                                                   np.float32)
                                        for s in source_ids]),
            "sample_name": f"{subject}-{frame}-{target_id}-"
                           f"{'-'.join(str(s) for s in source_ids)}-",
            "target_view_id": int(target_id),
            "src_view_ids": np.asarray([int(s) for s in source_ids]),
            "frame": frame,
        }
        validate_sample(sample)
        return sample

    def get_cam_sweep_extrinsics(self, nframes, scan_idx, elevation=0.0,
                                 radius=1.8, sweep_range=None):
        """A horizontal arc at `radius` about the head, spanning the source
        views' azimuths."""
        base = self.__getitem__(scan_idx)
        src_ext = base["src_extrinsics"]
        centers = -np.einsum("nji,nj->ni", src_ext[:, :3, :3],
                             src_ext[:, :3, 3])
        dirs = centers / np.linalg.norm(centers, axis=-1, keepdims=True)
        az = np.arctan2(dirs[:, 0], -dirs[:, 1])
        az_lo, az_hi = az.min(), az.max()
        if sweep_range is not None:
            mid = (az_lo + az_hi) / 2
            half = sweep_range / 360 * np.pi
            az_lo, az_hi = mid - half, mid + half
        el = elevation / 180 * np.pi
        exts = []
        for a in np.linspace(az_lo, az_hi, nframes):
            eye = radius * np.array([np.sin(a) * np.cos(el),
                                     -np.cos(a) * np.cos(el), np.sin(el)])
            z = -eye / np.linalg.norm(eye)
            up = np.array([0.0, 0.0, -1.0])
            x = np.cross(up, z)
            x /= np.linalg.norm(x)
            y = np.cross(z, x)
            ext = np.eye(4, dtype=np.float32)
            ext[:3, :3] = np.stack([x, y, z])
            ext[:3, 3] = -ext[:3, :3] @ eye
            exts.append(ext)
        return np.stack(exts)
