"""Folder-based evaluation: score `-pred.png` vs `-gt.png` pairs and write
the reports (port of diner_tpu.eval.suite).

The file contract is the reference's (src/evaluation/eval_suite.py:14-124 in
malteprinzler/diner): the filename suffixes below, average_scores.json,
detailed_report.json, and examples.png with [refs | gt | pred | depth] rows.
Metrics: ssim, psnr, l2, l1, and lpips when an LPIPS function is given
(`nn.lpips.make_lpips_fn`).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from diner_tpu_torch.eval.metrics import l1, mse, psnr, ssim
from diner_tpu_torch.image_ops.png import read_png, write_png

SUFFIXES = {
    "pred": "-pred.png",
    "gt": "-gt.png",
    "ref": "-ref.png",
    "depth": "-depth.png",
}
AVERAGE_SCORE_FILENAME = "average_scores.json"
REPORT_DETAIL_FILENAME = "detailed_report.json"
EXAMPLE_PLOT_FILENAME = "examples.png"
N_EXAMPLE_PLOTS = 5


def evaluate_folder(source_dir, outdir,
                    lpips_fn: Optional[Callable] = None,
                    n_examples: int = N_EXAMPLE_PLOTS):
    """Score all (gt, pred) pairs in `source_dir`; write the reports to
    `outdir`. lpips_fn (pred (H, W, 3) in [0, 1], gt) -> float adds an
    lpips column. Returns the dict of mean metrics."""
    source_dir, outdir = Path(source_dir), Path(outdir)
    os.makedirs(outdir, exist_ok=True)

    gt_paths = sorted(p for p in source_dir.iterdir()
                      if p.name.endswith(SUFFIXES["gt"]))
    if not gt_paths:
        raise FileNotFoundError(
            f"no '*{SUFFIXES['gt']}' files in {source_dir}: nothing to score")
    # absolute, so that the report's paths stay valid from any directory
    pred_paths = [(p.parent / p.name.replace(SUFFIXES["gt"],
                                             SUFFIXES["pred"])).resolve()
                  for p in gt_paths]

    scores = {k: [] for k in ("ssim", "psnr", "l2", "l1")
              } | ({"lpips": []} if lpips_fn else {})
    for gt_p, pred_p in zip(gt_paths, pred_paths):
        gt = read_png(gt_p).astype(np.float32)[..., :3] / 255.0
        pred = read_png(pred_p).astype(np.float32)[..., :3] / 255.0
        scores["ssim"].append(ssim(pred, gt, data_range=1))
        scores["psnr"].append(psnr(pred, gt, data_range=1))
        scores["l2"].append(mse(pred, gt))
        scores["l1"].append(l1(pred, gt))
        if lpips_fn:
            scores["lpips"].append(float(lpips_fn(pred, gt)))

    avg = {k: float(np.mean(v)) for k, v in scores.items()}
    with open(outdir / AVERAGE_SCORE_FILENAME, "w") as f:
        json.dump(avg, f, indent="\t")

    detailed = []
    for i, p in enumerate(pred_paths):
        row = {"path": str(p)}
        row.update({k: float(v[i]) for k, v in scores.items()})
        detailed.append(row)
    with open(outdir / REPORT_DETAIL_FILENAME, "w") as f:
        json.dump(detailed, f, indent="\t")

    _write_examples(pred_paths, outdir, n_examples)
    return avg


def _write_examples(pred_paths, outdir, n_examples):
    idcs = np.linspace(0, len(pred_paths) - 1,
                       min(n_examples, len(pred_paths))).astype(int)
    rows = []
    for idx in idcs:
        pred_p = pred_paths[idx]
        pred = read_png(pred_p)
        parts = []
        ref_p = pred_p.parent / pred_p.name.replace(SUFFIXES["pred"],
                                                    SUFFIXES["ref"])
        if ref_p.exists():
            ref = read_png(ref_p)
            nref = max(ref.shape[1] // pred.shape[1], 1)
            parts.extend(np.hsplit(ref[:, : nref * pred.shape[1]], nref))
        for key in ("gt", "pred", "depth"):
            p = pred_p.parent / pred_p.name.replace(SUFFIXES["pred"],
                                                    SUFFIXES[key])
            parts.append(read_png(p) if p.exists() else np.zeros_like(pred))
        parts = [a[..., :3] if a.ndim == 3 else np.repeat(a[..., None], 3, -1)
                 for a in parts]
        rows.append(np.concatenate(parts, axis=1))
    w = max(r.shape[1] for r in rows)
    rows = [np.pad(r, ((0, 0), (0, w - r.shape[1]), (0, 0))) for r in rows]
    write_png(Path(outdir) / EXAMPLE_PLOT_FILENAME,
              np.concatenate(rows, axis=0).astype(np.uint8))
