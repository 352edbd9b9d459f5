"""FaceScape per-view preprocessing pipeline (port of
diner_tpu.preprocess.facescape_pipeline).

Behavioral reference: deps/facescape_preprocessing/process_dataset.py:94-287
in malteprinzler/diner. Per subject/expression/view: undistort the raw image,
render the GT mesh depth (the batched rasterizer on `device` replaces
pyrender), silhouette square-crop to `crop_out`, adjust the intrinsics, and
write the files the FaceScape loader reads:
  view_XXXXX/{rgba.png, depth.png (uint16 1e-4 m)}, cameras.json.
The rigid canonical alignment (their precomputed per-scan similarity
transforms) is applied to the mesh before `process_view`. PNGs go through
the port's codec (image_ops/png.py), JPEG views through Pillow.

    python -m diner_tpu_torch.preprocess.facescape_pipeline \\
        --dir-in RAW/<subject> --dir-out PROCESSED/<subject> \\
        [--align-json ALIGN.json] [--device cuda|cpu]
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from diner_tpu_torch.core.device import resolve_device
from diner_tpu_torch.data.codecs import write_depth_png
from diner_tpu_torch.image_ops.png import read_png, write_png
from diner_tpu_torch.preprocess.facescape import (
    composite_rgba, crop_intrinsics, silhouette_square_crop, undistort_image)
from diner_tpu_torch.preprocess.rasterizer import render_depth


def read_image(path):
    """A view image as the array imageio returns: PNGs by the port's codec,
    other formats (the raw scans' JPEGs) by Pillow."""
    path = Path(path)
    if path.suffix.lower() == ".png":
        return read_png(path)
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def apply_similarity(vertices, scale: float, rotation, translation):
    """Rigid/similarity alignment to the canonical head frame (mm -> m etc.,
    process_dataset.py:116-133). Host numpy, as in JAX."""
    return (np.asarray(vertices) * scale) @ np.asarray(rotation).T \
        + np.asarray(translation)


def process_view(img, K, dist_coeffs, extrinsics, mesh_vertices, mesh_faces,
                 crop_out: int = 256, margin: float = 0.1, device="cuda"):
    """One camera view -> (rgba (crop, crop, 4), depth (crop, crop) [m],
    adjusted K (3, 3)), numpy arrays.

    img: (H, W, 3) uint8/float; K/dist/extrinsics: OpenCV calibration;
    mesh in the (aligned, metric) world frame, rendered on `device`."""
    import cv2

    img = np.asarray(img)
    H, W = img.shape[:2]
    und = undistort_image(img, K, dist_coeffs)

    depth_full, mask_full = render_depth(mesh_vertices, mesh_faces, K,
                                         extrinsics, H, W, device=device)
    depth_full, mask_full = depth_full.cpu().numpy(), mask_full.cpu().numpy()
    top, left, side = silhouette_square_crop(mask_full, crop_out, margin)

    def crop_resize(a, interp):
        c = a[top:top + side, left:left + side]
        return cv2.resize(c, (crop_out, crop_out), interpolation=interp)

    rgb = crop_resize(und, cv2.INTER_AREA)
    if rgb.dtype == np.uint8:
        rgb = rgb.astype(np.float32) / 255.0
    depth = crop_resize(depth_full, cv2.INTER_NEAREST)
    mask = crop_resize(mask_full.astype(np.uint8), cv2.INTER_NEAREST) > 0

    rgba = composite_rgba(rgb, mask)
    K_out = crop_intrinsics(K, top, left, side, crop_out)
    return rgba, depth, K_out


def write_view(out_dir, view_id: int, rgba, depth_m):
    """Write view_XXXXX/{rgba.png, depth.png} (facescape.py file contract)."""
    vdir = Path(out_dir) / f"view_{view_id:05d}"
    vdir.mkdir(parents=True, exist_ok=True)
    write_png(vdir / "rgba.png", (np.clip(rgba, 0, 1) * 255).astype(np.uint8))
    write_depth_png(vdir / "depth.png", depth_m)
    return vdir


def write_cameras(out_dir, cams: dict):
    """cams: {view_id: {"extrinsics": (3..4, 4), "intrinsics": (3, 3)}}."""
    ser = {str(k): {"extrinsics": np.asarray(v["extrinsics"])[:3].tolist(),
                    "intrinsics": np.asarray(v["intrinsics"]).tolist()}
           for k, v in cams.items()}
    p = Path(out_dir) / "cameras.json"
    p.write_text(json.dumps(ser, indent="\t"))
    return p


def read_cam_extrinsics(cam_dict, view_ids):
    """params.json -> per-view (4, 4) world->cam extrinsics
    (process_dataset.py key contract: `<i>_Rt`)."""
    out = {}
    for i in view_ids:
        rt = np.asarray(cam_dict[f"{i}_Rt"], np.float32)
        ext = np.eye(4, dtype=np.float32)
        ext[:3] = rt[:3]
        out[i] = ext
    return out


def process_subject(dir_in, dir_out, align=None, crop_out: int = 256,
                    margin: float = 0.1, device="cuda"):
    """Raw FaceScape subject -> loader-ready processed subject.

    Mirrors deps/facescape_preprocessing/process_dataset.py:94-287: for each
    numeric pose dir `<dir_in>/<pose>_*` containing `params.json` and the
    view images `<i>.jpg|png`, with the scan mesh at
    `<dir_in>/<pose>_*.ply`: apply the canonical similarity alignment,
    undistort + render mesh depth on `device` + silhouette-crop every valid
    view, and write `<dir_out>/<pose>/view_XXXXX/{rgba.png, depth.png}` +
    `cameras.json`.

    align: optional {pose: {"scale": s, "Rt": 4x4}} dict (the reference's
    precomputed align_Rts); identity when absent. Returns the list of
    processed pose output dirs.
    """
    from diner_tpu_torch.fusion.ply import read_ply_mesh

    dev = resolve_device(device)
    dir_in, dir_out = Path(dir_in), Path(dir_out)
    done = []
    pose_dirs = sorted(d for d in dir_in.iterdir()
                       if d.is_dir() and d.name[0].isdigit())
    for pose_dir in pose_dirs:
        pose = pose_dir.name.split("_")[0]
        params = pose_dir / "params.json"
        mesh_ply = pose_dir.parent / (pose_dir.name + ".ply")
        if not (params.exists() and mesh_ply.exists()):
            continue
        cam_dict = json.loads(params.read_text())
        imgs = sorted(p for p in pose_dir.iterdir()
                      if p.suffix.lower() in (".jpg", ".jpeg", ".png"))
        img_by_view = {p.stem: p for p in imgs}
        view_ids = [p.stem for p in imgs]
        exts = read_cam_extrinsics(cam_dict, view_ids)
        verts, faces = read_ply_mesh(mesh_ply)

        if align and pose in align:
            a = align[pose]
            rt = np.asarray(a["Rt"], np.float32)
            s = float(a["scale"])
            verts = apply_similarity(verts, s, rt[:3, :3], rt[:3, 3])
            # cameras move with the inverse of the world alignment
            # S(x) = s R x + t, S^-1(y) = R^T (y - t)/s. Composing
            # ext o S^-1 directly would bake 1/s into the rotation block
            # (non-rigid: downstream inverts extrinsics by transpose,
            # gen_rays geometry/rays.py). Scale the composed map by s to
            # keep it rigid: R' = R_e R_a^T, t' = s t_e - R' t_a — cameras
            # and rendered depths then live in aligned-world units.
            A_inv = np.eye(4, dtype=np.float32)
            A_inv[:3, :3] = rt[:3, :3].T
            A_inv[:3, 3] = -rt[:3, :3].T @ rt[:3, 3]

            def _compose(e):
                e = e.copy()
                e[:3, 3] *= s
                return e @ A_inv

            exts = {i: _compose(e) for i, e in exts.items()}

        # the mesh goes to the card once, for every view of the pose
        verts = torch.as_tensor(np.asarray(verts), dtype=torch.float64,
                                device=dev)
        faces = torch.as_tensor(np.asarray(faces), dtype=torch.int64,
                                device=dev)
        out_pose = dir_out / pose
        cams = {}
        for i in view_ids:
            if not cam_dict.get(f"{i}_valid", True):
                continue
            K = np.asarray(cam_dict[f"{i}_K"], np.float32)
            dist = np.asarray(cam_dict.get(f"{i}_distortion",
                                           [0, 0, 0, 0, 0]), np.float32)
            img = read_image(img_by_view[i])
            rgba, depth, K2 = process_view(img, K, dist, exts[i][:3],
                                           verts, faces, crop_out, margin,
                                           device=dev)
            write_view(out_pose, int(i), rgba, depth)
            cams[int(i)] = {"extrinsics": exts[i][:3], "intrinsics": K2}
        if cams:
            write_cameras(out_pose, cams)
            done.append(out_pose)
    return done


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="FaceScape raw-subject preprocessing "
                    "(process_dataset.py equivalent)")
    ap.add_argument("--dir-in", required=True)
    ap.add_argument("--dir-out", required=True)
    ap.add_argument("--crop-out", type=int, default=256)
    ap.add_argument("--margin", type=float, default=0.1)
    ap.add_argument("--align-json", default=None,
                    help="optional {pose: {scale, Rt}} canonical alignment")
    ap.add_argument("--device", default="cuda",
                    help="where the depth renders run: cuda (the default) "
                         "or cpu")
    args = ap.parse_args(argv)
    align = (json.loads(Path(args.align_json).read_text())
             if args.align_json else None)
    done = process_subject(args.dir_in, args.dir_out, align,
                           args.crop_out, args.margin, device=args.device)
    print(f"processed {len(done)} poses -> {args.dir_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
