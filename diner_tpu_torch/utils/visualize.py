"""Debug visualization: sample grids and camera rigs to PNG (host-side;
port of diner_tpu.utils.visualize). matplotlib is imported inside each
plotting function, with the Agg backend: the card machine has none, so
only the CSV point cloud runs there.

Behavioral reference: the per-dataset `visualize_item` / `visualize_camgrid`
matplotlib harnesses in malteprinzler/diner (src/data/dtu.py:342-419 etc.) —
here headless (Agg -> files) so they work in CI/pods.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def save_sample_grid(sample, outpath):
    """Plot target rgb + per-source rgb/alpha/depth rows for one contract
    sample dict; writes a PNG and returns its path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    nv = sample["src_rgbs"].shape[0]
    fig, axes = plt.subplots(3, nv + 1, figsize=(3 * (nv + 1), 9))
    axes[0, -1].imshow(np.asarray(sample["target_rgb"]))
    axes[0, -1].set_title("target")
    for i in range(nv):
        d = np.asarray(sample["src_depths"][i][..., 0])
        axes[0, i].imshow(np.asarray(sample["src_rgbs"][i]))
        axes[1, i].imshow(np.asarray(sample["src_alphas"][i][..., 0]),
                          cmap="gray")
        axes[2, i].imshow(d, vmin=d[d > 0].min() if (d > 0).any() else 0)
    for ax in axes.ravel():
        ax.axis("off")
    fig.suptitle(str(sample.get("sample_name", "")))
    fig.tight_layout()
    fig.savefig(outpath, dpi=100)
    plt.close(fig)
    return Path(outpath)


def save_camera_rig(extrinsics, outpath, labels=None, scale: float = 0.1):
    """3D quiver plot of camera positions/axes from world->cam extrinsics
    (N, 4, 4); writes a PNG."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ext = np.asarray(extrinsics)
    rot = np.transpose(ext[:, :3, :3], (0, 2, 1))
    centers = -np.einsum("nij,nj->ni", rot, ext[:, :3, 3])
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    for i, color in enumerate(["red", "green", "blue"]):
        ax.quiver(centers[:, 0], centers[:, 1], centers[:, 2],
                  scale * rot[:, 0, i], scale * rot[:, 1, i],
                  scale * rot[:, 2, i], color=color)
    for i in range(len(centers)):
        ax.text(*centers[i], str(labels[i] if labels else i))
    ax.set_xlabel("X")
    ax.set_ylabel("Y")
    ax.set_zlabel("Z")
    fig.savefig(outpath, dpi=100)
    plt.close(fig)
    return Path(outpath)


def reproject_depth_to_csv(depth, intrinsics, extrinsics, outpath, stride=1):
    """Backproject a metric depth map to a world-space point cloud CSV.

    Behavioral reference: the `reproject_depth` debug harness
    (src/data/facescape.py:442-478) — validate dataset geometry by dumping
    depth as x,y,z world points loadable in any viewer.

    depth: (H, W) metric; intrinsics: (3, 3); extrinsics: (4, 4) world->cam.
    Zero-depth pixels are skipped; `stride` subsamples the pixel grid.
    """
    depth = np.asarray(depth)
    K = np.asarray(intrinsics)
    ext = np.asarray(extrinsics)
    H, W = depth.shape
    ys, xs = np.mgrid[0:H:stride, 0:W:stride]
    d = depth[ys, xs]
    keep = d > 0
    xs, ys, d = xs[keep], ys[keep], d[keep]
    # pixel centers -> cam rays -> cam points
    pts_cam = np.stack([(xs + 0.5 - K[0, 2]) / K[0, 0] * d,
                        (ys + 0.5 - K[1, 2]) / K[1, 1] * d,
                        d], axis=-1)
    R, t = ext[:3, :3], ext[:3, 3]
    pts_world = (pts_cam - t) @ R  # R^T (p - t), row-vector form
    out = Path(outpath)
    header = "x,y,z"
    np.savetxt(out, pts_world, delimiter=",", header=header, comments="")
    return out
