"""The sample-dict contract between the datasets and the model (port of
diner_tpu.data.contract). Layout is NHWC:

| key               | shape            | meaning                              |
|-------------------|------------------|--------------------------------------|
| target_rgb        | (H, W, 3) 0..1   | GT novel view                        |
| target_alpha      | (H, W, 1)        | fg mask (all-ones for DTU)           |
| target_extrinsics | (4, 4)           | world->cam, OpenCV                   |
| target_intrinsics | (3, 3)           | K                                    |
| src_rgbs          | (NV, H, W, 3)    | source views                         |
| src_alphas        | (NV, H, W, 1)    | source fg masks                      |
| src_depths        | (NV, H, W, 1)    | MVS depth, metric, 0 = invalid       |
| src_depth_stds    | (NV, H, W, 1)    | per-pixel sigma = conf2std(conf)     |
| src_extrinsics    | (NV, 4, 4)       | source cams                          |
| src_intrinsics    | (NV, 3, 3)       | source K                             |
| sample_name       | str              | bookkeeping (non-array)              |

The readers add bookkeeping scalars (target_view_id, light_idx, scan_idx)
and arrays (src_view_ids), which `collate` stacks like the images.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

SAMPLE_KEYS = (
    "target_rgb", "target_alpha", "target_extrinsics", "target_intrinsics",
    "src_rgbs", "src_alphas", "src_depths", "src_depth_stds",
    "src_extrinsics", "src_intrinsics",
)


def validate_sample(sample: Dict) -> None:
    """Raise on contract violations (shapes, depth range)."""
    for k in SAMPLE_KEYS:
        if k not in sample:
            raise KeyError(f"sample missing contract key {k!r}")
    H, W, _ = sample["target_rgb"].shape
    NV = sample["src_rgbs"].shape[0]
    expect = {
        "target_rgb": (H, W, 3), "target_alpha": (H, W, 1),
        "target_extrinsics": (4, 4), "target_intrinsics": (3, 3),
        "src_rgbs": (NV, H, W, 3), "src_alphas": (NV, H, W, 1),
        "src_depths": (NV, H, W, 1), "src_depth_stds": (NV, H, W, 1),
        "src_extrinsics": (NV, 4, 4), "src_intrinsics": (NV, 3, 3),
    }
    for k, s in expect.items():
        if tuple(sample[k].shape) != s:
            raise ValueError(
                f"{k}: expected shape {s}, got {tuple(sample[k].shape)}")
    if np.any(np.asarray(sample["src_depths"]) < 0):
        raise ValueError("src_depths must be >= 0 (0 marks invalid)")


def collate(samples: List[Dict]) -> Dict:
    """Stack samples into a batch: arrays and numeric scalars are stacked,
    dicts of arrays (the MVS samples' pyramids) stacked key by key, other
    values (names) listed."""
    out = {}
    for k in samples[0]:
        v0 = samples[0][k]
        if isinstance(v0, np.ndarray) or (np.isscalar(v0)
                                          and not isinstance(v0, str)):
            out[k] = np.stack([np.asarray(s[k]) for s in samples])
        elif isinstance(v0, dict):
            out[k] = {kk: np.stack([s[k][kk] for s in samples]) for kk in v0}
        else:
            out[k] = [s[k] for s in samples]
    return out


def to_device_batch(batch: Dict) -> Dict:
    """The numpy-array entries of a collated batch."""
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
