"""Prediction-folder writer: render a dataset subset to PNG files for
scoring (port of diner_tpu.eval.predict).

Per sample it writes <name>-pred.png, -gt.png, -ref.png (the source views
side by side) and -depth.png (viridis), as the reference's
create_prediction_folder does (src/models/diner.py:99-136 in
malteprinzler/diner), over a deterministic Random(0) subset
(create_prediction_folder.py:36).
"""

from __future__ import annotations

import os
from pathlib import Path
from random import Random
from typing import Optional

import numpy as np

from diner_tpu_torch.data.contract import collate
from diner_tpu_torch.eval.suite import SUFFIXES
from diner_tpu_torch.image_ops.colormap import colormap
from diner_tpu_torch.image_ops.png import write_png


def _save(path, img01):
    write_png(path, (np.clip(np.asarray(img01), 0, 1) * 255).astype(np.uint8))


def deterministic_subset(n_total: int, n_samples: Optional[int],
                         seed: int = 0):
    idcs = list(range(n_total))
    if n_samples and 0 < n_samples < n_total:
        idcs = Random(seed).sample(idcs, n_samples)
    return idcs


def create_prediction_folder(render_fn, dataset, outdir, n_samples=None,
                             batch_size: int = 1, rng_seed: int = 0):
    """render_fn(batch, seed) -> (rgb (SB, H, W, 3), depth (SB, H, W)), as
    numpy arrays; batch is a collated sample dict of numpy arrays.

    Writes the four files per sample that eval.suite.evaluate_folder reads.
    """
    outdir = Path(outdir)
    os.makedirs(outdir, exist_ok=True)

    idcs = deterministic_subset(len(dataset), n_samples)
    for start in range(0, len(idcs), batch_size):
        chunk = idcs[start:start + batch_size]
        batch = collate([dataset[i] for i in chunk])
        names = batch.get("sample_name", [f"sample_{i:06d}" for i in chunk])
        rgb, depth = render_fn(batch, rng_seed + start)
        rgb, depth = np.asarray(rgb), np.asarray(depth)
        depth_rgb = colormap(depth[..., None])
        for i, name in enumerate(names):
            _save(outdir / f"{name}{SUFFIXES['pred']}", rgb[i])
            _save(outdir / f"{name}{SUFFIXES['depth']}", depth_rgb[i])
            _save(outdir / f"{name}{SUFFIXES['gt']}", batch["target_rgb"][i])
            refs = np.concatenate(list(batch["src_rgbs"][i]), axis=1)
            _save(outdir / f"{name}{SUFFIXES['ref']}", refs)
    return outdir
