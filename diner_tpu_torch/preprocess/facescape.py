"""FaceScape preprocessing core ops (port of diner_tpu.preprocess.facescape;
host numpy and cv2, as there).

Behavioral reference: deps/facescape_preprocessing/process_dataset.py:94-287
in malteprinzler/diner: per view, cv2-undistort the raw image, render mesh
depth (here by the batched rasterizer, preprocess/rasterizer.py), compute a
silhouette-based square crop to crop_out x crop_out (side-dependent
anchoring), and adjust the intrinsics accordingly. The rigid canonical-head
alignment and per-camera color calibration operate on dataset-specific
landmark/mesh inputs and are exposed as composable functions.
"""

from __future__ import annotations

import numpy as np


def undistort_image(img, K, dist_coeffs):
    """cv2.undistort with OpenCV distortion coefficients; returns same-size img."""
    import cv2

    return cv2.undistort(np.asarray(img), np.asarray(K, np.float64),
                         np.asarray(dist_coeffs, np.float64))


def silhouette_square_crop(mask, crop_out: int = 256, margin: float = 0.1):
    """Square crop window around the foreground silhouette.

    mask: (H, W) bool/0-1. Returns (y0, x0, side): crop `img[y0:y0+side,
    x0:x0+side]` then resize to crop_out. Anchoring keeps the crop inside the
    image, shifting toward the silhouette like the reference's side-dependent
    anchors (process_dataset.py:157-200).
    """
    mask = np.asarray(mask) > 0
    H, W = mask.shape
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        side = min(H, W)
        return (H - side) // 2, (W - side) // 2, side
    y0, y1 = ys.min(), ys.max()
    x0, x1 = xs.min(), xs.max()
    side = int(max(y1 - y0, x1 - x0) * (1 + 2 * margin))
    side = min(side, H, W)
    cy = (y0 + y1) // 2
    cx = (x0 + x1) // 2
    top = int(np.clip(cy - side // 2, 0, H - side))
    left = int(np.clip(cx - side // 2, 0, W - side))
    return top, left, side


def crop_intrinsics(K, top: int, left: int, side: int, crop_out: int):
    """Adjust K for a crop (top, left, side) resized to crop_out x crop_out."""
    K = np.asarray(K, np.float64).copy()
    K[0, 2] -= left
    K[1, 2] -= top
    K[:2] *= crop_out / side
    return K.astype(np.float32)


def composite_rgba(img, mask, bg: float = 1.0):
    """(H, W, 3) + (H, W) mask -> (H, W, 4) rgba with bg where mask==0."""
    img = np.asarray(img, np.float32)
    m = (np.asarray(mask) > 0).astype(np.float32)
    rgb = img * m[..., None] + bg * (1 - m[..., None])
    return np.concatenate([rgb, m[..., None]], axis=-1)
