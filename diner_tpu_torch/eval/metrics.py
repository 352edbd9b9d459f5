"""Image quality metrics with skimage-exact semantics (host-side numpy; port
of diner_tpu.eval.metrics).

The reference (src/evaluation/eval_suite.py:63-77 in malteprinzler/diner)
scores with skimage.metrics.{structural_similarity, peak_signal_noise_ratio,
mean_squared_error}, channel_axis=-1, data_range=1. SSIM is written out to
skimage's exact definition: 7x7 uniform filter (reflect boundary), sample
covariance normalization NP/(NP-1), K1=0.01, K2=0.03, border crop of
(win-1)//2, channel mean.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def mse(pred, gt):
    pred, gt = np.asarray(pred, np.float64), np.asarray(gt, np.float64)
    return float(np.mean((pred - gt) ** 2))


def l1(pred, gt):
    pred, gt = np.asarray(pred, np.float64), np.asarray(gt, np.float64)
    return float(np.mean(np.abs(pred - gt)))


def psnr(pred, gt, data_range: float = 1.0):
    err = mse(pred, gt)
    if err == 0:
        return float("inf")  # identical images (skimage semantics)
    return float(10.0 * np.log10((data_range ** 2) / err))


def _ssim_2d(im1, im2, win_size, data_range, K1=0.01, K2=0.03):
    im1 = im1.astype(np.float64)
    im2 = im2.astype(np.float64)
    NP = win_size ** 2
    cov_norm = NP / (NP - 1)
    f = lambda x: uniform_filter(x, size=win_size, mode="reflect")
    ux, uy = f(im1), f(im2)
    uxx, uyy, uxy = f(im1 * im1), f(im2 * im2), f(im1 * im2)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
        (ux ** 2 + uy ** 2 + C1) * (vx + vy + C2))
    pad = (win_size - 1) // 2
    return S[pad:S.shape[0] - pad, pad:S.shape[1] - pad].mean()


def ssim(pred, gt, data_range: float = 1.0, win_size: int = 7):
    """(H, W) or (H, W, C) SSIM, channel-averaged like skimage's
    channel_axis=-1."""
    pred, gt = np.asarray(pred), np.asarray(gt)
    if pred.ndim == 2:
        return float(_ssim_2d(pred, gt, win_size, data_range))
    vals = [_ssim_2d(pred[..., c], gt[..., c], win_size, data_range)
            for c in range(pred.shape[-1])]
    return float(np.mean(vals))
