"""Per-camera affine colour calibration (port of
diner_tpu.preprocess.color_calib).

Behavioral reference: deps/facescape_preprocessing/calibrate_colors.py:31-262
in malteprinzler/diner: fit a per-camera affine colour transform (3x3
matrix + offset) so mesh-vertex colours agree across views, using
rendered-depth visibility, then write rgba_colorcalib.png. The visibility
test renders the mesh on `device` (preprocess/rasterizer.py); the fit is the
closed-form ridge least squares below, on the host in float64.

    python -m diner_tpu_torch.preprocess.color_calib --pose-dir POSE \\
        --mesh MESH.ply [--device cuda|cpu]
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from diner_tpu_torch.core.device import resolve_device
from diner_tpu_torch.image_ops.png import read_png, write_png
from diner_tpu_torch.preprocess.rasterizer import render_depth


def fit_affine_color_transform(src_colors, ref_colors, l2: float = 1e-4):
    """Least-squares affine map A (3x4) with src @ A[:,:3].T + A[:,3] ~= ref.

    src_colors/ref_colors: (N, 3) in [0, 1]. Ridge-regularized toward
    identity. Returns (3, 4) float32.
    """
    src = np.asarray(src_colors, np.float64)
    ref = np.asarray(ref_colors, np.float64)
    X = np.concatenate([src, np.ones((len(src), 1))], axis=1)  # (N, 4)
    ident = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)  # (3, 4)
    # solve (X^T X + l2 I) A^T = X^T ref + l2 ident^T
    xtx = X.T @ X + l2 * np.eye(4) * max(len(src), 1)
    xty = X.T @ ref + l2 * max(len(src), 1) * ident.T
    A = np.linalg.solve(xtx, xty).T
    return A.astype(np.float32)


def apply_affine_color_transform(img, A):
    """img (H, W, 3) in [0, 1]; A (3, 4). Returns calibrated image in [0, 1]."""
    out = np.asarray(img, np.float32) @ A[:, :3].T + A[:, 3]
    return np.clip(out, 0.0, 1.0)


def _tensor(x, device):
    """x on `device` in its own floating dtype, so that the arithmetic
    promotes as numpy's does in the JAX function."""
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                        device=device)
    return t if t.is_floating_point() else t.to(torch.float64)


def vertex_visibility(vertices, faces, K, extrinsics, H, W,
                      depth_tol: float = 5e-3, device="cuda"):
    """Which mesh vertices are visible from a camera (z-buffer test): the
    depth render, projection and 3x3 neighbourhood test run on `device`.

    Returns numpy (visible (V,) bool, uv (V, 2) pixel coords).
    """
    dev = resolve_device(device)
    depth_map, _ = render_depth(vertices, faces, K, extrinsics, H, W,
                                device=dev)
    v, e, K = (_tensor(x, dev) for x in (vertices, extrinsics, K))
    dt = torch.promote_types(v.dtype, e.dtype)
    v, e = v.to(dt), e.to(dt)
    cam = v @ e[:3, :3].T + e[:3, 3]
    z = cam[:, 2]
    uv = cam[:, :2] / torch.clamp(z[:, None], min=1e-9)
    uv = uv * torch.stack([K[0, 0], K[1, 1]]) + torch.stack([K[0, 2], K[1, 2]])
    inside = (uv[:, 0] >= 0) & (uv[:, 0] < W) & (uv[:, 1] >= 0) \
        & (uv[:, 1] < H)
    # a vertex on a triangle edge/corner may round to a pixel its own
    # triangle doesn't cover -> accept agreement anywhere in the 3x3
    # neighbourhood
    ju0 = torch.round(uv[:, 0]).long()
    jv0 = torch.round(uv[:, 1]).long()
    best = torch.full(z.shape, float("inf"), dtype=z.dtype, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ju = torch.clamp(ju0 + dx, 0, W - 1)
            jv = torch.clamp(jv0 + dy, 0, H - 1)
            d = depth_map[jv, ju]
            err = torch.where(d > 0, torch.abs(d - z), inf)
            best = torch.minimum(best, err)
    visible = inside & (z > 0) & (best < depth_tol * torch.clamp(z, min=1))
    return visible.cpu().numpy(), uv.cpu().numpy()


def sample_vertex_colors(img, uv, visible):
    """Nearest-pixel vertex colors from an image; invisible -> NaN."""
    H, W = img.shape[:2]
    ju = np.clip(np.round(uv[:, 0]).astype(int), 0, W - 1)
    jv = np.clip(np.round(uv[:, 1]).astype(int), 0, H - 1)
    cols = np.asarray(img, np.float32)[jv, ju]
    cols[~visible] = np.nan
    return cols


def calibrate_cameras(vertex_colors_per_view):
    """Fit per-view affine transforms toward the cross-view mean.

    vertex_colors_per_view: (Ncam, Nvert, 3) with NaN for invisible vertices.
    Returns list of (3, 4) transforms; a view with under 16 vertices seen
    by it and by the mean keeps the identity.
    """
    stack = np.asarray(vertex_colors_per_view, np.float64)
    mean = np.nanmean(stack, axis=0)  # (Nvert, 3)
    out = []
    for v in range(stack.shape[0]):
        valid = ~np.isnan(stack[v]).any(axis=1) & ~np.isnan(mean).any(axis=1)
        if valid.sum() < 16:
            out.append(np.concatenate([np.eye(3), np.zeros((3, 1))],
                                      axis=1).astype(np.float32))
            continue
        out.append(fit_affine_color_transform(stack[v][valid], mean[valid]))
    return out


def calibrate_pose_dir(pose_dir, mesh_vertices, mesh_faces,
                       out_name: str = "rgba_colorcalib.png", device="cuda"):
    """Colour-calibrate one processed pose directory in place.

    Reads `view_XXXXX/rgba.png` + `cameras.json` (the facescape_pipeline
    output layout), computes per-view mesh-vertex visibility with the
    z-buffer rendered on `device`, fits per-view affine transforms toward
    the cross-view mean vertex colour (calibrate_colors.py:31-262 contract),
    and writes `view_XXXXX/rgba_colorcalib.png`. Returns {view_id: (3, 4) A}.
    """
    dev = resolve_device(device)
    pose_dir = Path(pose_dir)
    cams = json.loads((pose_dir / "cameras.json").read_text())
    view_ids = sorted(cams, key=int)
    # the mesh goes to the card once; the projection keeps its dtype
    verts = torch.as_tensor(np.asarray(mesh_vertices), device=dev)
    faces = torch.as_tensor(np.asarray(mesh_faces), dtype=torch.int64,
                            device=dev)
    imgs, colors = {}, []
    for i in view_ids:
        img = np.asarray(read_png(pose_dir / f"view_{int(i):05d}" /
                                  "rgba.png"), np.float32) / 255.0
        K = np.asarray(cams[i]["intrinsics"], np.float32)
        ext = np.asarray(cams[i]["extrinsics"], np.float32)
        H, W = img.shape[:2]
        visible, uv = vertex_visibility(verts, faces, K, ext, H, W,
                                        device=dev)
        colors.append(sample_vertex_colors(img[..., :3], uv, visible))
        imgs[i] = img
    transforms = calibrate_cameras(np.stack(colors))

    out = {}
    for i, A in zip(view_ids, transforms):
        img = imgs[i]
        rgb = apply_affine_color_transform(img[..., :3], A)
        rgba = np.concatenate([np.clip(rgb, 0, 1), img[..., 3:]], axis=-1)
        write_png(pose_dir / f"view_{int(i):05d}" / out_name,
                  (rgba * 255).astype(np.uint8))
        out[i] = A
    return out


def main(argv=None):
    import argparse

    from diner_tpu_torch.fusion.ply import read_ply_mesh

    ap = argparse.ArgumentParser(
        description="Per-camera affine color calibration "
                    "(calibrate_colors.py equivalent)")
    ap.add_argument("--pose-dir", required=True,
                    help="processed pose dir (view_XXXXX/ + cameras.json)")
    ap.add_argument("--mesh", required=True, help="aligned scan mesh .ply")
    ap.add_argument("--device", default="cuda",
                    help="where the visibility renders run: cuda (the "
                         "default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    verts, faces = read_ply_mesh(args.mesh)
    out = calibrate_pose_dir(args.pose_dir, verts, faces, device=args.device)
    print(f"calibrated {len(out)} views in {args.pose_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
