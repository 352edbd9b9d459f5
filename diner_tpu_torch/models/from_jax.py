"""Carry weights over from the JAX package: flax parameters -> the port's
state_dict.

Input: flax `params` (and `batch_stats` for BatchNorm) as nested dicts of
arrays, or flat dicts with "a/b/c" keys such as
tests/fixtures/fastpath_tiny.npz, or a whole variables tree {"params": ...,
"batch_stats": ...}. Keys keep the tree's own root, so a DINER tree
("nerf/...", "vgg/...") maps onto DINER's state_dict, its VGG tower
included, and a PixelNeRF tree onto PixelNeRF's.

Mapping:
- conv kernels HWIO -> OIHW; Dense kernels (in, out) -> (out, in)
- GroupNorm / BatchNorm `scale`, `bias` -> `weight`, `bias`
- BatchNorm `mean`, `var` (batch_stats) -> `running_mean`, `running_var`
- module names: Conv_i -> conv_i, _Norm_i -> norm_i, Dense_0/1 -> fc_0/1,
  lin_z_i -> lin_z.i, block_i -> blocks.i
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

_RENAMES = [
    (re.compile(r"^Conv_(\d+)$"), r"conv_\1"),
    (re.compile(r"^_Norm_(\d+)$"), r"norm_\1"),
    (re.compile(r"^Dense_(\d+)$"), r"fc_\1"),
    (re.compile(r"^lin_z_(\d+)$"), r"lin_z.\1"),
    (re.compile(r"^block_(\d+)$"), r"blocks.\1"),
]
_NORM_SCOPES = ("GroupNorm_0", "BatchNorm_0")
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def _rename(path: str) -> str:
    parts = path.split("/")
    out = []
    for seg in parts[:-1]:
        if seg in _NORM_SCOPES:
            continue
        for pat, rep in _RENAMES:
            if pat.match(seg):
                seg = pat.sub(rep, seg)
                break
        out.append(seg)
    if parts[-1] not in _LEAVES:
        raise KeyError(f"unknown flax leaf {path!r}")
    out.append(_LEAVES[parts[-1]])
    return ".".join(out)


def _convert(leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and value.ndim == 4:   # HWIO -> OIHW
        return value.transpose(3, 2, 0, 1)
    if leaf == "kernel" and value.ndim == 2:   # (in, out) -> (out, in)
        return value.T
    return value


def from_jax(params: Mapping, batch_stats: Optional[Mapping] = None
             ) -> Dict[str, torch.Tensor]:
    """flax params (+ batch_stats), or a variables tree holding both, -> the
    port's state_dict (float32)."""
    if "params" in params:
        if batch_stats is not None:
            raise ValueError("pass batch_stats inside the variables tree or "
                             "beside its params, not both")
        params, batch_stats = params["params"], params.get("batch_stats")
    flat = _flatten(params)
    if batch_stats is not None:
        flat.update(_flatten(batch_stats))
    sd = {}
    for path, value in flat.items():
        leaf = path.split("/")[-1]
        sd[_rename(path)] = torch.from_numpy(np.ascontiguousarray(
            _convert(leaf, value.astype(np.float32))))
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key[: -len("running_mean")] + "num_batches_tracked"] = \
            torch.tensor(0)
    return sd
