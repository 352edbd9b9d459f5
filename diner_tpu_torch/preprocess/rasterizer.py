"""Triangle-mesh depth rasterizer (z-buffer, OpenCV pinhole), batched on the
card (port of diner_tpu.preprocess.rasterizer).

Behavioral reference: the reference renders GT depth maps and foreground
masks from meshes with pyrender (deps/facescape_preprocessing/renderer.py:
66-92 `render_cvcam`, deps/multiface/process_dataset.py:50-110). The JAX
package replaced it with a numpy z-buffer that loops over triangles; this
port keeps that z-buffer's arithmetic in float64 and enumerates every
(triangle, bounding-box pixel) pair in batched tensor ops on `device`, with
no loop over triangles. Camera convention: world->cam extrinsics, +z
forward, y down.
"""

from __future__ import annotations

import torch

from diner_tpu_torch.core.device import resolve_device

# (triangle, pixel) pairs enumerated at once: a chunk holds at most this
# many, which bounds its transient tensors to about 250 B a pair (about
# 4 GiB at the default); a triangle whose bounding box alone holds more is
# split into bands of rows
PAIR_BUDGET = 1 << 24


def _project(vertices, extrinsics, K, near: float):
    """World points (V, 3) -> pixel coordinates (V, 2) and cam z (V,), the
    divide by z clamped at `near`."""
    cam = vertices @ extrinsics[:3, :3].T + extrinsics[:3, 3]
    z = cam[:, 2]
    uv = cam[:, :2] / torch.clamp(z[:, None], min=near)
    uv = uv * torch.stack([K[0, 0], K[1, 1]]) + torch.stack([K[0, 2], K[1, 2]])
    return uv, z


def _bands(y0, y1, bw, half: int):
    """Split each triangle's bbox rows y0..y1 (width bw) into bands of at
    most `half` pixels -> (triangle of each band, first row, rows)."""
    rows_per_band = torch.clamp(half // bw, min=1)
    n_bands = (y1 - y0 + rows_per_band) // rows_per_band
    tri = torch.repeat_interleave(
        torch.arange(len(y0), device=y0.device), n_bands)
    first = torch.cumsum(n_bands, 0) - n_bands
    j = torch.arange(len(tri), device=y0.device) - first[tri]
    start = y0[tri] + j * rows_per_band[tri]
    rows = torch.minimum(rows_per_band[tri], y1[tri] - start + 1)
    return tri, start, rows


def render_depth(vertices, faces, K, extrinsics, H: int, W: int,
                 near: float = 1e-4, device="cuda"):
    """Z-buffer depth render.

    vertices: (V, 3) world space; faces: (F, 3) int; K: (3, 3); extrinsics:
    (4, 4) world->cam (numpy arrays or tensors). Returns (depth (H, W)
    float32 with 0 = no hit, mask (H, W) bool), tensors on `device`.

    The JAX z-buffer's semantics, in float64: a triangle with a vertex at
    z <= near, or whose floor/ceil bbox lies off the frame, is dropped, and
    so is one with |edge-function denominator| < 1e-12; pixel centres sit at
    +0.5 in the bbox clipped to the frame; a pixel is inside when all three
    edge-function weights are >= 0; the depth is perspective-correct,
    1 / sum(w_i / z_i), and the nearest hit wins (a scatter of the minimum,
    which no order of the pairs changes). At most PAIR_BUDGET (triangle,
    pixel) pairs are enumerated at once; it must be at least 2 W.
    """
    dev = resolve_device(device)
    if PAIR_BUDGET < 2 * W:
        raise ValueError(f"PAIR_BUDGET {PAIR_BUDGET} is under 2 W = {2 * W}")
    f64 = torch.float64
    vertices = torch.as_tensor(vertices, dtype=f64, device=dev)
    faces = torch.as_tensor(faces, dtype=torch.int64, device=dev)
    K = torch.as_tensor(K, dtype=f64, device=dev)
    extrinsics = torch.as_tensor(extrinsics, dtype=f64, device=dev)
    uv, z = _project(vertices, extrinsics, K, near)
    depth = torch.full((H * W,), float("inf"), dtype=f64, device=dev)

    tri_uv = uv[faces]                              # (F, 3, 2)
    tri_z = z[faces]                                # (F, 3)
    a, b, c = tri_uv[:, 0], tri_uv[:, 1], tri_uv[:, 2]
    den = (b[:, 1] - c[:, 1]) * (a[:, 0] - c[:, 0]) \
        + (c[:, 0] - b[:, 0]) * (a[:, 1] - c[:, 1])
    # conservative screen-space bbox culling; the floor/ceil are clamped
    # just outside the frame before the integer cast, which keeps the
    # on/off-frame tests and keeps the cast in range
    lim = float(max(H, W))
    mins = torch.floor(tri_uv.amin(1)).clamp(-1.0, lim).long()
    maxs = torch.ceil(tri_uv.amax(1)).clamp(-1.0, lim).long()
    valid = (tri_z > near).all(1) & torch.isfinite(tri_uv).all(2).all(1)
    valid &= (maxs[:, 0] >= 0) & (maxs[:, 1] >= 0)
    valid &= (mins[:, 0] < W) & (mins[:, 1] < H)
    valid &= den.abs() >= 1e-12
    keep = valid.nonzero()[:, 0]
    x0 = mins[keep, 0].clamp(min=0)
    y0 = mins[keep, 1].clamp(min=0)
    x1 = maxs[keep, 0].clamp(max=W - 1)
    y1 = maxs[keep, 1].clamp(max=H - 1)
    bw = x1 - x0 + 1
    a, b, c, tri_z, den = a[keep], b[keep], c[keep], tri_z[keep], den[keep]
    # per triangle: the edge-function coefficients in the JAX formula's
    # operand order, the third vertex and the vertices' z
    coef = torch.stack([b[:, 1] - c[:, 1], c[:, 0] - b[:, 0],
                        c[:, 1] - a[:, 1], a[:, 0] - c[:, 0],
                        c[:, 0], c[:, 1], den,
                        tri_z[:, 0], tri_z[:, 1], tri_z[:, 2]], 1)

    half = PAIR_BUDGET // 2
    tri, row0, rows = _bands(y0, y1, bw, half)
    area = bw[tri] * rows
    start = torch.cumsum(area, 0) - area
    # a chunk takes the bands that start in its half-budget window: at
    # most half of pairs begin there, and the last band adds at most half
    chunk = start // half
    counts = torch.bincount(chunk).tolist() if len(chunk) else []
    i0 = 0
    for n in counts:
        if n == 0:
            continue
        i1 = i0 + n
        a_chunk = area[i0:i1]
        s_chunk = start[i0:i1] - start[i0]
        n_pairs = int(s_chunk[-1] + a_chunk[-1])
        band = torch.repeat_interleave(
            torch.arange(n, device=dev), a_chunk, output_size=n_pairs)
        k = torch.arange(n_pairs, device=dev) - s_chunk[band]
        t = tri[i0:i1][band]
        width = bw[t]
        px = x0[t] + k % width
        py = row0[i0:i1][band] + k // width
        gx = px.to(f64) + 0.5
        gy = py.to(f64) + 0.5
        q = coef[t]
        dx, dy = gx - q[:, 4], gy - q[:, 5]
        w0 = (q[:, 0] * dx + q[:, 1] * dy) / q[:, 6]
        w1 = (q[:, 2] * dx + q[:, 3] * dy) / q[:, 6]
        w2 = 1.0 - w0 - w1
        inside = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0)).nonzero()[:, 0]
        q = q[inside]
        zi = 1.0 / (w0[inside] / q[:, 7] + w1[inside] / q[:, 8]
                    + w2[inside] / q[:, 9])
        depth.scatter_reduce_(0, py[inside] * W + px[inside], zi, "amin")
        i0 = i1

    mask = torch.isfinite(depth)
    out = torch.where(mask, depth, torch.zeros((), dtype=f64, device=dev))
    return out.to(torch.float32).reshape(H, W), mask.reshape(H, W)
