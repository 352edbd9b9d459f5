"""Inputs on which the kernels are held against their plain versions.

chip_smoke.py and tests/test_torch_kernels.py draw K3's inputs here, with
numpy from a seed, so that one recipe serves the card and the CPU; the
callers move them to their device.
"""

from __future__ import annotations

import numpy as np
import torch


def chord_inputs(seed, SB, NV, NR, NC, A):
    """K3 inputs: sorted candidates in [1, 3]; chords whose parameter t(z)
    runs from about 0 to about 1 (P0 = dd w0 c0 and P1 = dd w1 c1 make t a
    weighted mean of c0 ~ 0 and c1 ~ 1); a few rays behind the camera, with
    dd_ok = 0 or chord_ok = 0; anchor depths along each chord's cam-depth
    range, so that both sides of every gate occur."""
    rng = np.random.RandomState(seed)
    z = np.sort(rng.uniform(1.0, 3.0, (SB, NR, NC)), -1).astype(np.float32)
    w0 = rng.uniform(0.5, 2.0, (SB, NV, NR))
    w1 = rng.uniform(0.3, 1.0, (SB, NV, NR))
    w0[:, :, :2] = -3.0
    dd = rng.uniform(0.05, 2.0, (SB, NV, NR))
    c0 = rng.uniform(-0.1, 0.1, (SB, NV, NR))
    c1 = rng.uniform(0.9, 1.1, (SB, NV, NR))
    hs = rng.uniform(0.001, 0.01, (SB, 1, NR)).repeat(NV, 1)
    scal = np.stack([w0, w1, dd * w0 * c0, dd * w1 * c1, 1.0 / dd,
                     rng.rand(SB, NV, NR) > 0.1, rng.rand(SB, NV, NR) > 0.1,
                     hs], -1).astype(np.float32)
    zc0, zc1 = (w0 + 1.0 * w1)[..., None], (w0 + 3.0 * w1)[..., None]
    frac = (np.arange(A) + 0.5) / A
    depth = zc0 + frac * (zc1 - zc0) + rng.uniform(-0.02, 0.02,
                                                   (SB, NV, NR, A))
    std = rng.uniform(0.0, 0.05, (SB, NV, NR, A))
    std[rng.rand(SB, NV, NR, A) < 0.2] = 0.0
    cos = rng.rand(SB, NV, NR, A) - 0.7
    vals = np.stack([depth, std, cos], 3).astype(np.float32)
    return z, scal, vals


# std and cos values at the edges of K3's gates and of its 1 / (sqrt2 std):
# signed zeros, tiny (a normal 1e-30, the least normal float, a subnormal),
# negative, infinite, NaN, and a std whose sqrt2 std overflows
EDGE_STDS = (0.0, -0.0, 1e-30, 1.1754944e-38, 1e-40, -0.03, float("inf"),
             float("-inf"), float("nan"), 3e38)
EDGE_COS = (0.5, 0.0, -0.0, float("nan"))


def with_edge_cases(vals, seed=0):
    """A copy of K3's vals (SB, NV, NR, 3, A) float32 numpy with about a
    quarter of the anchors' std and a sixth of their cos replaced by
    EDGE_STDS and EDGE_COS."""
    rng = np.random.RandomState(seed)
    vals = vals.copy()
    shape = vals[:, :, :, 0].shape
    for ch, edges, share in ((1, EDGE_STDS, 0.25), (2, EDGE_COS, 0.15)):
        pick = rng.rand(*shape) < share
        edge = np.asarray(edges, np.float32)[rng.randint(0, len(edges),
                                                         shape)]
        vals[:, :, :, ch] = np.where(pick, edge, vals[:, :, :, ch])
    return vals


def max_abs_diff(x, ref):
    """Largest |x - ref| where ref is not NaN; inf where the NaNs of x and
    ref differ in place."""
    nan = ref.isnan()
    if not torch.equal(x.isnan(), nan):
        return float("inf")
    return (x - ref).abs().masked_fill(nan, 0.0).max().item()
