"""MVS datasets for depth-prior writing and evaluation (port of
diner_tpu.mvs.datasets; the same layouts, views and numpy samples).

- DTUMVSDataset: DTU in the 4-view corner configuration. Reference and
  source views come from the fixed corner-camera tables (tl/bl/tr/br); 7
  lights for training, light 3 otherwise; 1600x1200 images are halved,
  then cropped to 512x640; GT depth and mask pyramids at /4, /2 and /1.
- FacescapeMVSDataset, MultifaceMVSDataset: leave-one-out over the unique
  4-camera sets of the DINER readers' metas, on the port's readers.
- GeneralEvalMVSDataset: the MVSNet eval layout <scan>/{images, cams,
  pair.txt}, images capped to 864x1152 and snapped down to multiples of 32.
- BlendedMVSDataset: the BlendedMVS finetuning layout, with GT pyramids.
- TnTEvalDataset: Tanks and Temples scenes at their capture sizes, snapped
  down to multiples of 32, no GT.

A sample holds imgs (V, H, W, 3), proj_matrices {"stage1".."stage3":
(V, 2, 4, 4)} ([extrinsics, intrinsics] with the intrinsics at the stage's
resolution), depth_values (D,), the GT depth path dpath where the dataset
has one, and the GT pyramids depth/mask where the files exist.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from diner_tpu_torch.core.config import register
from diner_tpu_torch.data.codecs import (nearest_resize, read_depth_png,
                                         read_pfm)

# corner-camera id tables
_TL = [10, 0, 1, 2, 9, 13, 12, 11, 10]
_BL = [30, 27, 26, 25, 31, 45, 46, 47, 29]
_TR = [6, 2, 3, 4, 5, 18, 17, 16, 7]
_BR = [35, 22, 21, 20, 36, 40, 41, 42, 34]


def corner_view_metas(mode: str):
    """[(target_id, [3 source ids])]: each corner's cams against the other
    corners'; in any mode but "train" only the first cam of each corner."""
    tl, bl, tr, br = (_TL, _BL, _TR, _BR) if mode == "train" else (
        _TL[:1], _BL[:1], _TR[:1], _BR[:1])
    targets = tl + bl + tr + br
    srcs = ([list(t) for t in zip(bl, tr, br)]
            + [list(t) for t in zip(tl, tr, br)]
            + [list(t) for t in zip(tl, bl, br)]
            + [list(t) for t in zip(tl, bl, tr)])
    return list(zip(targets, srcs))


def prepare_img(hr_img):
    """1600x1200 -> halved; then the central 512x640 crop (a smaller image
    passes whole)."""
    h, w = hr_img.shape[:2]
    ds = hr_img[::2, ::2] if (h, w) == (1200, 1600) else hr_img
    h, w = ds.shape[:2]
    start_h, start_w = (h - 512) // 2, (w - 640) // 2
    return ds[start_h:start_h + 512, start_w:start_w + 640]


def _pyramid(img):
    """{"stage3": img, "stage2": img at /2, "stage1": img at /4}, nearest."""
    h, w = img.shape[:2]
    out = {"stage3": img}
    for stage, s in (("stage2", 2), ("stage1", 4)):
        ys = (np.arange(h // s) * s).astype(np.int64)
        xs = (np.arange(w // s) * s).astype(np.int64)
        out[stage] = img[ys][:, xs]
    return out


def _read_cam_txt(path):
    """An MVSNet cam file -> (K (3, 3), extrinsics (4, 4), the tokens of its
    depth line, which each dataset reads its own way)."""
    lines = [ln.rstrip() for ln in Path(path).read_text().splitlines()]
    ext = np.fromstring(" ".join(lines[1:5]), np.float32, sep=" ")
    K = np.fromstring(" ".join(lines[7:10]), np.float32, sep=" ")
    return K.reshape(3, 3), ext.reshape(4, 4), lines[11].split()


def _stage_pyramid_projs(projs):
    """(V, 2, 4, 4) stage-1 [extrinsics, K4] stacks -> the 3-stage dict, the
    intrinsics x2 at stage 2 and x4 at stage 3."""
    out = {"stage1": projs}
    for name, sc in (("stage2", 2.0), ("stage3", 4.0)):
        p = projs.copy()
        p[:, 1, :2] *= sc
        out[name] = p
    return out


def _k4(K, divide: float = 1.0):
    """3x3 intrinsics -> 4x4, the first two rows divided by `divide`."""
    K4 = np.eye(4, dtype=np.float32)
    K4[:3, :3] = K
    K4[:2] /= divide
    return K4


@register("DTUMVSDataset")
class DTUMVSDataset:
    """DTU for MVS training and depth-prior writing."""

    def __init__(self, datapath, listfile, mode: str = "train",
                 nviews: int = 4, ndepths: int = 192,
                 interval_scale: float = 1.06):
        if nviews != 4:
            raise ValueError("DTUMVSDataset's corner views are 4 a sample")
        self.datapath = Path(datapath)
        self.mode = mode
        self.ndepths = ndepths
        self.interval_scale = interval_scale
        scans = [ln.strip() for ln in Path(listfile).read_text().splitlines()
                 if ln.strip()]
        lights = range(7) if mode == "train" else [3]
        self.metas = [(scan, light, t, s)
                      for scan in scans
                      for t, s in corner_view_metas(mode)
                      for light in lights]

    def __len__(self):
        return len(self.metas)

    def _read_cam(self, path):
        K, ext, vals = _read_cam_txt(path)
        return K, ext, float(vals[0]), float(vals[1]) * self.interval_scale

    def __getitem__(self, idx):
        from PIL import Image

        scan, light, target, srcs = self.metas[idx]
        view_ids = [target] + list(srcs)
        imgs, projs = [], []
        depth_values = depth_ms = mask_ms = dpath = None
        for i, vid in enumerate(view_ids):
            img_p = (self.datapath / f"Rectified/{scan}_train" /
                     f"rect_{vid + 1:03d}_{light}_r5000.png")
            img = np.asarray(Image.open(img_p), np.float32) / 255.0
            imgs.append(prepare_img(img))
            K, ext, dmin, dint = self._read_cam(
                self.datapath / "Cameras/train" / f"{vid:08d}_cam.txt")
            projs.append(np.stack([ext, _k4(K)]))
            if i == 0:
                depth_values = dmin + np.arange(self.ndepths,
                                                dtype=np.float32) * dint
                dpath = str(self.datapath / "Depths" / scan /
                            f"depth_map_{vid:04d}.pfm")
                if Path(dpath).exists():
                    depth_ms = _pyramid(prepare_img(read_pfm(dpath)[0]))
                    mask_ms = {k: (v > 0).astype(np.float32)
                               for k, v in depth_ms.items()}
        sample = {
            "imgs": np.stack(imgs),
            "proj_matrices": _stage_pyramid_projs(np.stack(projs)),
            "depth_values": depth_values,
            "dpath": dpath,
            "view_ids": np.asarray(view_ids),
            "scan": scan,
            "light_idx": light,
        }
        if depth_ms is not None:
            sample["depth"] = depth_ms
            sample["mask"] = mask_ms
        return sample


@register("FacescapeMVSDataset")
class FacescapeMVSDataset:
    """FaceScape: every reference view of each unique camera quadruple once
    as the MVS reference, the other three as sources; hypotheses
    linspace(znear=1, zfar=2.5, D); stage-1 intrinsics the full-resolution
    ones / 4."""

    znear = 1.0
    zfar = 2.5

    def __init__(self, root, stage: str = "train", ndepths: int = 384,
                 meta_dir=None, **facescape_kwargs):
        from diner_tpu_torch.data.facescape import FacescapeDataset

        # the metas are filtered by the GT mesh depth: the DINER default,
        # depth_TransMVSNet.png, is what the writer is about to create
        facescape_kwargs.setdefault("depth_fname", "depth.png")
        self.base = FacescapeDataset(root, stage=stage, meta_dir=meta_dir,
                                     **facescape_kwargs)
        self.ndepths = ndepths
        seen, self.metas = set(), []
        for m in self.base.metas:
            key = (m["scan_path"], tuple(tuple(r) for r in m["ref_ids"]))
            if key in seen:
                continue
            seen.add(key)
            self.metas += [(m, r) for r in range(len(m["ref_ids"]))]

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx):
        from diner_tpu_torch.data.facescape import _read_rgba, _to_h

        if not self.metas:
            raise IndexError(
                f"FacescapeMVSDataset is empty (stage={self.base.stage!r}, "
                f"root={self.base.data_dir}); check that depth files pass "
                "the zfar/frontal meta filters and that the split has "
                "subjects")
        meta, ref_slot = self.metas[idx]
        ref_ids = [s[0] for s in meta["ref_ids"]]
        view_ids = [ref_ids[ref_slot]] + [r for i, r in enumerate(ref_ids)
                                          if i != ref_slot]
        scan_path = self.base.data_dir / meta["scan_path"]
        cam_dict = json.loads((scan_path / "cameras.json").read_text())
        imgs, projs = [], []
        dpath = depth_ms = mask_ms = None
        for i, vid in enumerate(view_ids):
            vdir = scan_path / self.base.int_to_viewdir(int(vid))
            rgb, alpha = _read_rgba(vdir / self.base.RGBA_FNAME)
            imgs.append(rgb)
            K = np.asarray(cam_dict[vid]["intrinsics"], np.float32)
            projs.append(np.stack([_to_h(cam_dict[vid]["extrinsics"]),
                                   _k4(K, 4.0)]))
            if i == 0:
                dpath = str(vdir / "depth.png")
                if Path(dpath).exists():
                    d = read_depth_png(dpath).astype(np.float32)
                    depth_ms = _pyramid(d)
                    a = np.asarray(alpha, np.float32).reshape(d.shape)
                    mask_ms = _pyramid(((a > 0.5) & (d > 0))
                                       .astype(np.float32))
        sample = {
            "imgs": np.stack(imgs),
            "proj_matrices": _stage_pyramid_projs(np.stack(projs)),
            "depth_values": np.linspace(self.znear, self.zfar, self.ndepths
                                        ).astype(np.float32),
            "dpath": dpath,
            "view_ids": np.asarray([int(v) for v in view_ids]),
            "scan": meta["scan_path"],
        }
        if depth_ms is not None:
            sample["depth"] = depth_ms
            sample["mask"] = mask_ms
        return sample


@register("GeneralEvalMVSDataset")
class GeneralEvalMVSDataset:
    """The MVSNet eval layout: <scan>/{images/XXXXXXXX<ext>,
    cams/XXXXXXXX_cam.txt, pair.txt}. pair.txt gives each reference view's
    sources; the hypotheses come from the cam file's depth line."""

    def __init__(self, datapath, scans, nviews: int = 5, ndepths: int = 192,
                 interval_scale: float = 1.06, img_ext: str = ".jpg",
                 max_h: int = 864, max_w: int = 1152):
        self.datapath = Path(datapath)
        self.nviews = nviews
        self.ndepths = ndepths
        self.interval_scale = interval_scale
        self.img_ext = img_ext
        self.max_h, self.max_w = max_h, max_w
        self.metas = [(scan, ref, srcs) for scan in scans
                      for ref, srcs in _read_pair(
                          self.datapath / scan / "pair.txt") if srcs]

    def __len__(self):
        return len(self.metas)

    @staticmethod
    def scale_mvs_input(img, K, max_w, max_h, base: int = 32):
        """Cap to (max_h, max_w) keeping the aspect, snap both sides down to
        a multiple of `base` and scale K to match. Resizes with cv2 where it
        is installed, else with Pillow through uint8."""
        h, w = img.shape[:2]
        if h > max_h or w > max_w:
            scale = max_h / h
            if scale * w > max_w:
                scale = max_w / w
            new_w, new_h = scale * w // base * base, scale * h // base * base
        else:
            new_w, new_h = w // base * base, h // base * base
        K = K.copy()
        K[0, :] *= new_w / w
        K[1, :] *= new_h / h
        if (new_h, new_w) != (h, w):
            try:
                import cv2

                img = cv2.resize(img, (int(new_w), int(new_h)))
            except ImportError:
                from PIL import Image

                img = np.asarray(Image.fromarray(
                    (img * 255).astype(np.uint8)).resize(
                        (int(new_w), int(new_h))), np.float32) / 255.0
        return img, K

    def _read_cam(self, path):
        K, ext, vals = _read_cam_txt(path)
        dmin, dint = float(vals[0]), float(vals[1])
        if len(vals) >= 3:
            # [min, interval, num]: num * interval spread over ndepths
            dmax = dmin + int(float(vals[2])) * dint
            dint = (dmax - dmin) / self.ndepths
        return K, ext, dmin, dint * self.interval_scale

    def __getitem__(self, idx):
        scan, ref, srcs = self.metas[idx]
        view_ids = [ref] + srcs[: self.nviews - 1]
        imgs, projs = [], []
        depth_values = None
        for i, vid in enumerate(view_ids):
            img = _read_rgb(
                self.datapath / scan / "images" / f"{vid:08d}{self.img_ext}")
            K, ext, dmin, dint = self._read_cam(
                self.datapath / scan / "cams" / f"{vid:08d}_cam.txt")
            img, K = self.scale_mvs_input(img, K, self.max_w, self.max_h)
            imgs.append(img)
            # the cam files hold full-resolution K; stage 1 is at /4
            projs.append(np.stack([ext, _k4(K, 4.0)]))
            if i == 0:
                depth_values = dmin + np.arange(self.ndepths,
                                                dtype=np.float32) * dint
        return {"imgs": np.stack(imgs),
                "proj_matrices": _stage_pyramid_projs(np.stack(projs)),
                "depth_values": depth_values,
                "view_ids": np.asarray(view_ids), "scan": scan}


@register("MultifaceMVSDataset")
class MultifaceMVSDataset(FacescapeMVSDataset):
    """MultiFace: leave-one-out over the unique camera quadruples of the
    DINER MultiFace metas, hypotheses linspace(0.5, 1.5, D), downsampled
    frames."""

    znear = 0.5
    zfar = 1.5

    def __init__(self, root, stage: str = "val", ndepths: int = 384,
                 downsample: int = 8, **mf_kwargs):
        from diner_tpu_torch.data.multiface import MultiFaceDataset

        self.base = MultiFaceDataset(root, stage=stage, downsample=downsample,
                                     **mf_kwargs)
        self.ndepths = ndepths
        # keep the base index: __getitem__ borrows the DINER sample
        seen, self.metas = set(), []
        for bi, m in enumerate(self.base.metas):
            key = (m["scan_path"], tuple(m["ref_ids"]))
            if key in seen:
                continue
            seen.add(key)
            self.metas += [(bi, m, r) for r in range(4)]

    def __getitem__(self, idx):
        base_idx, meta, ref_slot = self.metas[idx]
        ref_ids = list(meta["ref_ids"])
        view_ids = [ref_ids[ref_slot]] + [r for i, r in enumerate(ref_ids)
                                          if i != ref_slot]
        s = self.base[base_idx]
        order = [ref_ids.index(v) for v in view_ids]
        imgs = s["src_rgbs"][order]
        projs = np.stack([np.stack([e, _k4(K, 4.0)]) for e, K in
                          zip(s["src_extrinsics"][order],
                              s["src_intrinsics"][order])])
        # the reference view's GT depth path, which the priors are named by
        scan_path = Path(meta["scan_path"])
        subject = scan_path.parents[3].name
        seq = scan_path.parents[1].name
        frame = scan_path.stem
        ref_img = (self.base.data_dir / subject / "images" / seq /
                   str(view_ids[0]) / f"{frame}.png")
        dpath = str(self.base._dpath(ref_img))
        sample = {"imgs": imgs,
                  "proj_matrices": _stage_pyramid_projs(projs),
                  "depth_values": np.linspace(self.znear, self.zfar,
                                              self.ndepths).astype(np.float32),
                  "dpath": dpath,
                  "view_ids": np.asarray([int(v) for v in view_ids]),
                  "scan": meta["scan_path"]}
        if Path(dpath).exists():
            d = np.asarray(self.base.read_depth(Path(dpath)), np.float32)
            if d.ndim == 3:
                d = d[..., 0]
            # the GT is at capture resolution, the images downsampled
            h, w = imgs.shape[1:3]
            if d.shape != (h, w):
                d = nearest_resize(d, h, w)
            sample["depth"] = _pyramid(d)
            sample["mask"] = {k: (v > 0).astype(np.float32)
                              for k, v in sample["depth"].items()}
        return sample


def _read_pair(path):
    """pair.txt -> [(reference view, [source views])] in file order."""
    pair = Path(path).read_text().splitlines()
    out = []
    for i in range(int(pair[0])):
        ref = int(pair[1 + 2 * i])
        out.append((ref, [int(x) for x in pair[2 + 2 * i].split()[1::2]]))
    return out


def _read_rgb(path):
    from PIL import Image

    return np.asarray(Image.open(path), np.float32)[..., :3] / 255.0


@register("BlendedMVSDataset")
class BlendedMVSDataset:
    """BlendedMVS for finetuning: <scan>/blended_images/XXXXXXXX.jpg,
    <scan>/cams/{pair.txt, XXXXXXXX_cam.txt},
    <scan>/rendered_depth_maps/XXXXXXXX.pfm. A reference view needs
    nviews - 1 sources in pair.txt. The cam files hold full-resolution K
    (stage 1 takes it / 4) and the depth bounds [min, ..., max]: the
    hypotheses are min + i * (max - min) / ndepths, and the GT mask keeps
    the depths inside the first and the last hypothesis. dpath is the
    reference view's rendered depth map, next to which `cli/mvs write`
    puts its priors."""

    def __init__(self, datapath, listfile, mode: str = "train",
                 nviews: int = 4, ndepths: int = 192,
                 interval_scale: float = 1.0):
        self.datapath = Path(datapath)
        self.nviews = nviews
        self.ndepths = ndepths
        if isinstance(listfile, (str, Path)):
            scans = [ln.strip() for ln in
                     Path(listfile).read_text().splitlines() if ln.strip()]
        else:
            scans = list(listfile)
        self.metas = [(scan, ref, srcs) for scan in scans
                      for ref, srcs in _read_pair(
                          self.datapath / scan / "cams" / "pair.txt")
                      if len(srcs) >= nviews - 1]

    def __len__(self):
        return len(self.metas)

    def _read_cam(self, path):
        K, ext, vals = _read_cam_txt(path)
        dmin, dmax = float(vals[0]), float(vals[-1])
        return K, ext, dmin, (dmax - dmin) / self.ndepths

    def __getitem__(self, idx):
        scan, ref, srcs = self.metas[idx]
        root = self.datapath / scan
        imgs, projs = [], []
        for i, vid in enumerate([ref] + srcs[: self.nviews - 1]):
            imgs.append(_read_rgb(root / "blended_images" / f"{vid:08d}.jpg"))
            K, ext, dmin, dint = self._read_cam(
                root / "cams" / f"{vid:08d}_cam.txt")
            projs.append(np.stack([ext, _k4(K, 4.0)]))
            if i == 0:
                ref_dmin, ref_dint = dmin, dint
        dpath = root / "rendered_depth_maps" / f"{ref:08d}.pfm"
        depth = read_pfm(dpath)[0]
        depth_end = ref_dmin + ref_dint * (self.ndepths - 1)
        mask = ((depth >= ref_dmin) & (depth <= depth_end)).astype(np.float32)
        return {"imgs": np.stack(imgs),
                "proj_matrices": _stage_pyramid_projs(np.stack(projs)),
                "depth": _pyramid(depth), "mask": _pyramid(mask),
                "depth_values": ref_dmin + np.arange(
                    self.ndepths, dtype=np.float32) * ref_dint,
                "depth_interval": np.asarray(ref_dint, np.float32),
                "scan": scan, "dpath": str(dpath)}


# the capture sizes (W, H) of the Tanks and Temples scenes
TNT_IMAGE_SIZES = {
    "Family": (1920, 1080), "Francis": (1920, 1080), "Horse": (1920, 1080),
    "Lighthouse": (2048, 1080), "M60": (2048, 1080), "Panther": (2048, 1080),
    "Playground": (1920, 1080), "Train": (1920, 1080),
    "Auditorium": (1920, 1080), "Ballroom": (1920, 1080),
    "Courtroom": (1920, 1080), "Museum": (1920, 1080),
    "Palace": (1920, 1080), "Temple": (1920, 1080),
}


@register("TnTEvalDataset")
class TnTEvalDataset:
    """Tanks and Temples for evaluation (no GT): <scan>/images/XXXXXXXX.jpg,
    <scan>/cams_1/XXXXXXXX_cam.txt (stage-1 K), <scan>/pair.txt. Images are
    capped to the scene's capture size and snapped down to multiples of 32
    with K scaled to match; with fix_res, the first image read fixes the
    resolution of every later one (bilinear through uint8, K scaled). The
    hypotheses are min + i * (max - min) / ndepths of the cam file's
    bounds."""

    def __init__(self, datapath, scans, nviews: int = 5, ndepths: int = 192,
                 image_sizes=None, fix_res: bool = True):
        self.datapath = Path(datapath)
        self.nviews = nviews
        self.ndepths = ndepths
        self.image_sizes = dict(TNT_IMAGE_SIZES, **(image_sizes or {}))
        self.fix_res = fix_res
        self._fixed_hw = None
        self.metas = [(scan, ref, srcs) for scan in scans
                      for ref, srcs in _read_pair(
                          self.datapath / scan / "pair.txt") if srcs]

    def __len__(self):
        return len(self.metas)

    def _read_cam(self, path):
        K, ext, vals = _read_cam_txt(path)
        dmin, dmax = float(vals[0]), float(vals[-1])
        return K, ext, dmin, (dmax - dmin) / self.ndepths

    def __getitem__(self, idx):
        from PIL import Image

        scan, ref, srcs = self.metas[idx]
        view_ids = [ref] + srcs[: min(self.nviews, len(srcs) + 1) - 1]
        max_w, max_h = self.image_sizes.get(scan, (1920, 1080))
        imgs, projs = [], []
        for i, vid in enumerate(view_ids):
            K, ext, dmin, dint = self._read_cam(
                self.datapath / scan / "cams_1" / f"{vid:08d}_cam.txt")
            img, K = GeneralEvalMVSDataset.scale_mvs_input(
                _read_rgb(self.datapath / scan / "images" / f"{vid:08d}.jpg"),
                K, max_w, max_h)
            if self.fix_res and self._fixed_hw is None:
                self._fixed_hw = img.shape[:2]
            if self._fixed_hw is not None and img.shape[:2] != self._fixed_hw:
                sh = self._fixed_hw[0] / img.shape[0]
                sw = self._fixed_hw[1] / img.shape[1]
                img = np.asarray(Image.fromarray(
                    (img * 255).astype(np.uint8)).resize(
                        (self._fixed_hw[1], self._fixed_hw[0]),
                        Image.BILINEAR), np.float32) / 255.0
                K = K.copy()
                K[0] *= sw
                K[1] *= sh
            imgs.append(img)
            projs.append(np.stack([ext, _k4(K)]))
            if i == 0:
                depth_values = dmin + np.arange(self.ndepths,
                                                dtype=np.float32) * dint
        return {"imgs": np.stack(imgs),
                "proj_matrices": _stage_pyramid_projs(np.stack(projs)),
                "depth_values": depth_values,
                "view_ids": np.asarray(view_ids), "scan": scan}
