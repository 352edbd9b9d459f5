"""Geometric-consistency depth filtering (port of
diner_tpu.fusion.consistency).

Each reference pixel is reprojected into a source view with its depth, the
source depth is sampled there (bilinear, zeros outside), and the point is
carried back: a pixel is consistent with that source when the round trip
lands within a pixel threshold and a relative depth threshold. The fused
depth averages the consistent reprojections with the pixel's own; a pixel
is kept when enough sources agree. The JAX package vmaps the whole
pairwise sweep in one program; here each reference view loops over its
sources, so memory stays at a few maps a pair (a 49-view DTU scan at
512x640 fits the card) while each pair is one batch of tensor ops on the
maps' device.
"""

from __future__ import annotations

import numpy as np
import torch

from diner_tpu_torch.image_ops.grid_sample import grid_sample


def _pixel_grid(H: int, W: int, like):
    gy, gx = torch.meshgrid(
        torch.arange(H, dtype=like.dtype, device=like.device),
        torch.arange(W, dtype=like.dtype, device=like.device), indexing="ij")
    return gx, gy


def reproject_with_depth(depth_ref, K_ref, ext_ref, depth_src, K_src,
                         ext_src):
    """Round-trip reprojection. depth_*: (H, W); K_*: (3, 3); ext_*: (4, 4)
    world->cam. Returns (depth_reprojected, x_reproj, y_reproj, x_src,
    y_src), each (H, W)."""
    H, W = depth_ref.shape
    gx, gy = _pixel_grid(H, W, depth_ref)
    ones = torch.ones(H * W, dtype=depth_ref.dtype, device=depth_ref.device)
    pix = torch.stack([gx.reshape(-1), gy.reshape(-1), ones])
    xyz_ref = torch.linalg.inv(K_ref) @ (pix * depth_ref.reshape(-1))
    rel = ext_src @ torch.linalg.inv(ext_ref)
    xyz_src = rel[:3, :3] @ xyz_ref + rel[:3, 3:4]
    k_src = K_src @ xyz_src
    xy_src = k_src[:2] / k_src[2:3]
    # cv2.remap's bilinear sampling: pixel centres at integer coordinates
    u = (xy_src[0] + 0.5) / W * 2 - 1
    v = (xy_src[1] + 0.5) / H * 2 - 1
    sampled = grid_sample(depth_src[None, :, :, None],
                          torch.stack([u, v], -1)[None], mode="bilinear",
                          padding_mode="zeros")[0, :, 0]
    xyz_src2 = torch.linalg.inv(K_src) @ (
        torch.cat([xy_src, ones[None]], 0) * sampled)
    rel_back = ext_ref @ torch.linalg.inv(ext_src)
    xyz_rep = rel_back[:3, :3] @ xyz_src2 + rel_back[:3, 3:4]
    depth_rep = xyz_rep[2].reshape(H, W)
    k_rep = K_ref @ xyz_rep
    z = torch.where(k_rep[2:3] == 0, torch.ones_like(k_rep[2:3]), k_rep[2:3])
    xy_rep = k_rep[:2] / z
    return (depth_rep, xy_rep[0].reshape(H, W), xy_rep[1].reshape(H, W),
            xy_src[0].reshape(H, W), xy_src[1].reshape(H, W))


def _consistency(depth_ref, depth_rep, xr, yr):
    """The round trip's pixel distance and relative depth error."""
    H, W = depth_ref.shape
    gx, gy = _pixel_grid(H, W, depth_ref)
    dist = torch.sqrt((xr - gx) ** 2 + (yr - gy) ** 2)
    denom = torch.where(depth_ref == 0, torch.ones_like(depth_ref), depth_ref)
    return dist, torch.abs(depth_rep - depth_ref) / denom


def check_geometric_consistency(depth_ref, K_ref, ext_ref, depth_src, K_src,
                                ext_src, pixel_thresh: float = 1.0,
                                rel_depth_thresh: float = 0.01):
    """(mask (H, W) bool, depth_reprojected (H, W), zero where the pixel is
    not consistent)."""
    depth_rep, xr, yr, _, _ = reproject_with_depth(
        depth_ref, K_ref, ext_ref, depth_src, K_src, ext_src)
    dist, rel = _consistency(depth_ref, depth_rep, xr, yr)
    mask = (dist < pixel_thresh) & (rel < rel_depth_thresh) & (depth_ref > 0)
    return mask, torch.where(mask, depth_rep, torch.zeros_like(depth_rep))


def filter_depths(depths, intrinsics, extrinsics, confidences,
                  conf_thresh: float = 0.5, thres_view: int = 3):
    """The full pairwise consistency sweep. depths, confidences: (V, H, W);
    intrinsics (V, 3, 3); extrinsics (V, 4, 4). Returns (depth_averaged
    (V, H, W), final_mask (V, H, W) bool): each view's fused depth (its own
    and its consistent reprojections, averaged) and the photometric and
    geometric acceptance mask."""
    V = depths.shape[0]
    avgs, finals = [], []
    for r in range(V):
        geo = torch.zeros_like(depths[r], dtype=torch.int64)
        dep = torch.zeros_like(depths[r])
        for s in range(V):
            if s == r:
                continue
            mask, d = check_geometric_consistency(
                depths[r], intrinsics[r], extrinsics[r], depths[s],
                intrinsics[s], extrinsics[s])
            geo = geo + mask.long()
            dep = dep + d
        avgs.append((dep + depths[r]) / (geo + 1))
        finals.append((confidences[r] > conf_thresh) & (geo >= thres_view))
    return torch.stack(avgs), torch.stack(finals)


def filter_depths_dynamic(depths, intrinsics, extrinsics, confidences,
                          conf_thresh: float = 0.5):
    """Dynamic fusion's progressive thresholds: a pixel is kept when, at
    some support level i in 1..V-1, at least i sources agree within i/4 px
    and i/1300 relative depth; its fused depth averages the level-1
    consistent reprojections with its own. Returns (depth_averaged,
    final_mask) as `filter_depths`. Each pair's reprojection is computed
    once and thresholded at every level."""
    V = depths.shape[0]
    levels = torch.arange(1, V, dtype=depths.dtype, device=depths.device)
    lv = levels[:, None, None]
    avgs, finals = [], []
    for r in range(V):
        geo = torch.zeros((V - 1, *depths.shape[1:]), dtype=torch.int64,
                          device=depths.device)
        dep = torch.zeros_like(depths[r])
        for s in range(V):
            if s == r:
                continue
            depth_rep, xr, yr, _, _ = reproject_with_depth(
                depths[r], intrinsics[r], extrinsics[r], depths[s],
                intrinsics[s], extrinsics[s])
            dist, rel = _consistency(depths[r], depth_rep, xr, yr)
            masks = ((dist < lv / 4.0) & (rel < lv / 1300.0)
                     & (depths[r] > 0))
            geo = geo + masks.long()
            dep = dep + torch.where(masks[0], depth_rep,
                                    torch.zeros_like(depth_rep))
        ok_any = (geo >= levels.long()[:, None, None]).any(dim=0)
        avgs.append((dep + depths[r]) / (geo[0] + 1))
        finals.append((confidences[r] > conf_thresh) & ok_any
                      & (depths[r] > 0))
    return torch.stack(avgs), torch.stack(finals)


def depths_to_world_points(depths, intrinsics, extrinsics, colors, mask):
    """Backproject the masked depths to world points on the host.
    depths (V, H, W); colors (V, H, W, 3) in [0, 1]; mask (V, H, W) bool.
    Returns (points (N, 3) float32, colors (N, 3) uint8)."""
    depths, mask, colors = (np.asarray(a.cpu() if torch.is_tensor(a) else a)
                            for a in (depths, mask, colors))
    intrinsics, extrinsics = (np.asarray(a.cpu() if torch.is_tensor(a)
                                         else a)
                              for a in (intrinsics, extrinsics))
    pts_all, col_all = [], []
    V, H, W = depths.shape
    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    for v in range(V):
        m = mask[v]
        if not m.any():
            continue
        d = depths[v][m]
        x, y = gx[m], gy[m]
        xyz_cam = np.linalg.inv(intrinsics[v]) @ (
            np.stack([x, y, np.ones_like(x)]) * d)
        pose = np.linalg.inv(extrinsics[v])
        xyz_w = pose[:3, :3] @ xyz_cam + pose[:3, 3:4]
        pts_all.append(xyz_w.T.astype(np.float32))
        col_all.append((colors[v][m] * 255).astype(np.uint8))
    if not pts_all:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint8)
    return np.concatenate(pts_all), np.concatenate(col_all)
