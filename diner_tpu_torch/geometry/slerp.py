"""Pose interpolation for camera sweeps (a numpy/scipy copy of
diner_tpu.geometry.slerp). Rotations interpolate by scipy's spherical slerp;
locations piecewise-linearly, clamped to the key times. Host-side: it builds
sweep extrinsics, not tensors.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation, Slerp as _RotSlerp


class PoseSlerp:
    """Interpolate (rotation, location) keyframes over scalar times."""

    def __init__(self, times, rotations: Rotation, locations):
        times = np.asarray(times, dtype=np.float64)
        locations = np.asarray(locations, dtype=np.float64)
        order = np.argsort(times)
        self._times = times[order]
        self._locations = locations[order]
        self._rotslerp = _RotSlerp(self._times, rotations[order])

    def __call__(self, query_times):
        q = np.clip(np.atleast_1d(np.asarray(query_times, dtype=np.float64)),
                    self._times.min(), self._times.max())
        rotations = self._rotslerp(q)
        idx = np.clip(np.searchsorted(self._times, q, side="right") - 1,
                      0, len(self._times) - 2)
        t0, t1 = self._times[idx], self._times[idx + 1]
        w1 = np.clip((q - t0) / np.maximum(t1 - t0, 1e-4), 0.0, 1.0)
        locations = ((1 - w1[:, None]) * self._locations[idx]
                     + w1[:, None] * self._locations[idx + 1])
        return rotations, locations
