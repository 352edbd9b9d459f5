"""Consensus point-cloud fusion, fusibile's method (port of
diner_tpu.fusion.consensus).

Every reference pixel backprojects its depth, reprojects into every other
view, and counts the views whose depth agrees and whose normal deviates by
less than normal_thresh; it averages its own and the agreeing views' 3D
points, normals and colours, and is kept with at least num_consistent
agreeing views. Depth agreement is "relative" (|z - d_s| / d_s <
depth_thresh) or "disparity" (fusibile's test, |f_ref * B * (1/z - 1/d_s)|
< depth_thresh with the reference's fx and the baseline between the two
camera centres).

The JAX package vmaps all reference and source views at once. Here the
reference views go one at a time and their sources in chunks of
SRC_CHUNK, the sums accumulating over the chunks, so that the live memory
is a few (SRC_CHUNK, H*W, 3) tensors: a 49-view DTU scan at 512x640 fits
the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SRC_CHUNK = 16


def _tensor(x, device):
    if x is None:
        return None
    x = torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x))
    return x.to(device=device, dtype=torch.float32)


def consensus_fusion(depths, intrinsics, extrinsics, colors=None,
                     normals=None, depth_thresh: float = 0.01,
                     normal_thresh: float = 0.5, num_consistent: int = 3,
                     depth_mode: str = "relative", device=None):
    """Fuse per-view depth maps into a consensus point set.

    depths (V, H, W), 0 invalid; intrinsics (V, 3, 3); extrinsics (V, 4,
    4) world->cam; colors (V, H, W, 3) and normals (V, H, W, 3), camera
    space, optional; numpy arrays or tensors, computed on `device` (the
    depths' own by default). Without normals every view gets fusibile's
    fake-normal constant, so the normal test passes. Returns a dict of
    per-pixel tensors flattened over (V, H, W): "points" (N, 3), "normals"
    (N, 3), "colors" (N, 3) and "keep" (N,) bool.
    """
    if depth_mode not in ("relative", "disparity"):
        raise ValueError(
            f"depth_mode must be relative|disparity, got {depth_mode!r}")
    if device is None:
        device = depths.device if torch.is_tensor(depths) else "cpu"
    depths = _tensor(depths, device)
    intrinsics = _tensor(intrinsics, device)
    extrinsics = _tensor(extrinsics, device)
    V, H, W = depths.shape
    HW = H * W
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32,
                                         device=device),
                            torch.arange(W, dtype=torch.float32,
                                         device=device), indexing="ij")
    pix = torch.stack([gx, gy, torch.ones_like(gx)]).reshape(3, -1)
    inv_K = torch.linalg.inv(intrinsics)
    poses = torch.linalg.inv(extrinsics)
    world_pts = (poses[:, :3, :3] @ (inv_K @ (pix * depths.reshape(V, 1, HW)))
                 + poses[:, :3, 3:4]).transpose(1, 2)          # (V, HW, 3)
    if normals is None:
        world_nrm = torch.full((V, HW, 3), 3.0 ** -0.5, device=device)
    else:
        world_nrm = torch.einsum(
            "vij,vnj->vni", extrinsics[:, :3, :3].transpose(-1, -2),
            _tensor(normals, device).reshape(V, -1, 3))
    cols = (torch.ones((V, HW, 3), device=device) if colors is None
            else _tensor(colors, device).reshape(V, -1, 3))
    flat_depths = depths.reshape(V, HW)
    cos_t = math.cos(normal_thresh)

    pts_out, nrm_out, col_out, keep_out = [], [], [], []
    for r in range(V):
        pts_r = world_pts[r]
        n_ok = torch.zeros(HW, dtype=torch.int64, device=device)
        sum_p = torch.zeros_like(pts_r)
        sum_n = torch.zeros_like(pts_r)
        sum_c = torch.zeros_like(pts_r)
        for s0 in range(0, V, SRC_CHUNK):
            src = torch.arange(s0, min(s0 + SRC_CHUNK, V), device=device)
            R = extrinsics[src, :3, :3]
            cam = torch.einsum("sij,nj->sni", R, pts_r) \
                + extrinsics[src, None, :3, 3]                 # (S, HW, 3)
            z = cam[..., 2]
            uvw = torch.einsum("sij,snj->sni", intrinsics[src], cam)
            zs = torch.where(z == 0, torch.ones_like(z), z)
            u = uvw[..., 0] / zs
            v = uvw[..., 1] / zs
            ju = torch.round(u).to(torch.int32).clamp(0, W - 1)
            jv = torch.round(v).to(torch.int32).clamp(0, H - 1)
            inside = ((u >= -0.5) & (u < W - 0.5) & (v >= -0.5)
                      & (v < H - 0.5) & (z > 0))
            idx = (jv * W + ju).long()                          # (S, HW)
            d_s = torch.gather(flat_depths[src], 1, idx)
            if depth_mode == "disparity":
                f_ref = intrinsics[r, 0, 0]
                baseline = torch.linalg.norm(
                    poses[r, None, :3, 3] - poses[src, :3, 3], dim=-1)
                inv_z = 1.0 / torch.where(z <= 0, torch.ones_like(z), z)
                inv_d = 1.0 / torch.where(d_s <= 0, torch.ones_like(d_s),
                                          d_s)
                agree = (torch.abs(f_ref * baseline[:, None]
                                   * (inv_z - inv_d)) < depth_thresh)
            else:
                denom = torch.where(d_s == 0, torch.ones_like(d_s), d_s)
                agree = torch.abs(z - d_s) / denom < depth_thresh
            gidx = idx[..., None].expand(-1, -1, 3)
            nrm_s = torch.gather(world_nrm[src], 1, gidx)
            n_dot = (world_nrm[r] * nrm_s).sum(-1)
            ok = (inside & (d_s > 0) & agree & (n_dot > cos_t)
                  & (src != r)[:, None])
            okf = ok.float()[..., None]
            n_ok += ok.sum(0)
            sum_p += (torch.gather(world_pts[src], 1, gidx) * okf).sum(0)
            sum_n += (nrm_s * okf).sum(0)
            sum_c += (torch.gather(cols[src], 1, gidx) * okf).sum(0)
        denom = (n_ok + 1).float()[:, None]
        pts_out.append((pts_r + sum_p) / denom)
        nrm_out.append((world_nrm[r] + sum_n) / denom)
        col_out.append((cols[r] + sum_c) / denom)
        keep_out.append((flat_depths[r] > 0) & (n_ok >= num_consistent))
    return {"points": torch.cat(pts_out), "normals": torch.cat(nrm_out),
            "colors": torch.cat(col_out), "keep": torch.cat(keep_out)}
