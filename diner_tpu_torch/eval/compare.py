"""Multi-model evaluation comparison plots (port of diner_tpu.eval.compare).

Behavioral reference: src/evaluation/eval_suite.py:127-385
(compare_evaluations) in malteprinzler/diner:
  1. violin plots of per-sample metric distributions across models, with the
     best mean colored green / worst red per metric's optimization direction
     and mean +- standard-error annotations;
  2. side-by-side example sheets: each model's examples.png strip is split
     into its N example rows and restacked per example across models, with
     model-name labels (examples_{i}.png);
  3. "what is the difference" plots: per metric, the samples with the highest
     across-model score spread, shown as gt + every model's prediction + L1
     error maps (diff_{metric}_{j}.png).
Offline analysis tooling over the detailed_report.json / examples.png files
written by evaluate_folder. PNGs are read by the port's codec
(image_ops/png.py); matplotlib (Agg) is imported when the plots are drawn,
and the card machine has none.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from diner_tpu_torch.eval.suite import (EXAMPLE_PLOT_FILENAME,
                                        N_EXAMPLE_PLOTS,
                                        REPORT_DETAIL_FILENAME, SUFFIXES)
from diner_tpu_torch.image_ops.png import read_png

METRIC_OPT = dict(l1="-", l2="-", lpips="-", psnr="+", ssim="+")


def load_detailed_report(report_dir):
    return json.loads((Path(report_dir) / REPORT_DETAIL_FILENAME).read_text())


def _violins(reports, names, metrics, outdir, plt):
    fig, axes = plt.subplots(len(metrics), 1,
                             figsize=(max(3 * len(names), 6),
                                      3 * len(metrics)))
    for ax, metric in zip(np.atleast_1d(axes), metrics):
        data = [np.asarray([row[metric] for row in rep]) for rep in reports]
        means = np.array([d.mean() for d in data])
        stds = np.array([d.std() for d in data])
        ns = np.array([len(d) for d in data])
        opt = METRIC_OPT.get(metric, "-")
        best = int(np.argmax(means) if opt == "+" else np.argmin(means))
        worst = int(np.argmin(means) if opt == "+" else np.argmax(means))
        colors = ["#1f77b4"] * len(names)
        colors[worst] = "red"
        colors[best] = "green"  # after red: a single model is best, not worst

        x = np.arange(len(names))
        parts = ax.violinplot(data, positions=x, showextrema=False, widths=0.9)
        for pc, c in zip(parts["bodies"], colors):
            pc.set_facecolor(c)
        ax.scatter(x, means, c="black", zorder=3)
        ax.vlines(x, means - stds, means + stds, color="black")
        for j, (m, s, n) in enumerate(zip(means, stds, ns)):
            ax.text(j, m, f"  {m:.3f}+-{s / np.sqrt(max(n, 1)):.3f}",
                    ha="left", va="center")
        ax.set_xticks(x)
        ax.set_xticklabels(names, rotation=30)
        ax.set_ylabel(f"{metric.upper()} ({opt})")
    fig.tight_layout()
    fig.savefig(outdir / "metric_violins.png", dpi=120)
    plt.close(fig)


def _example_sheets(reports, report_dirs, names, outdir, plt):
    """Restack each model's examples.png rows per example across models
    (eval_suite.py:246-277)."""
    strips = {}
    # examples.png has min(N_EXAMPLE_PLOTS, n_pairs) rows (suite.py
    # _write_examples) — splitting into a fixed 5 would straddle row
    # boundaries for folders with fewer pairs
    n_rows = min(N_EXAMPLE_PLOTS,
                 *[len(rep) for rep in reports])
    if n_rows <= 0:
        return
    for name, d, rep in zip(names, report_dirs, reports):
        p = Path(d) / EXAMPLE_PLOT_FILENAME
        if not p.exists():
            return
        strips[name] = np.array_split(
            read_png(p), min(N_EXAMPLE_PLOTS, len(rep)), axis=0)
    for i in range(n_rows):
        rows = [strips[n][i][..., :3] for n in names]
        w = max(r.shape[1] for r in rows)
        rows = [np.pad(r, ((0, 0), (0, w - r.shape[1]), (0, 0)),
                       constant_values=255) for r in rows]
        fig, axes = plt.subplots(len(names), 1,
                                 figsize=(w / 100, sum(r.shape[0] for r in
                                                       rows) / 100))
        for ax, r, n in zip(np.atleast_1d(axes), rows, names):
            ax.imshow(r)
            ax.set_ylabel(n, fontsize=12)
            ax.set_xticks([])
            ax.set_yticks([])
        fig.tight_layout()
        fig.savefig(outdir / f"examples_{i}.png", dpi=100)
        plt.close(fig)


def _difference_plots(reports, names, report_dirs, metrics, outdir,
                      n_samples, plt):
    """Per metric: samples with the highest across-model spread, as
    gt / predictions / L1 error maps (eval_suite.py:279-385)."""
    by_name = [{Path(r["path"]).name: r for r in rep} for rep in reports]
    common = sorted(set.intersection(*[set(b) for b in by_name]))
    if not common:
        return
    for metric in metrics:
        spread = {s: np.std([b[s][metric] for b in by_name]) for s in common}
        worst = sorted(common, key=lambda s: spread[s],
                       reverse=True)[:n_samples]
        for j, stem in enumerate(worst):
            preds, gt = [], None
            for b in by_name:
                p = Path(b[stem]["path"])
                if not p.exists():
                    # reports written by older evaluate_folder versions
                    # stored cwd-relative paths
                    print(f"compare: missing prediction {p} — run "
                          "compare_evaluations from the directory "
                          "evaluate_folder ran in, or re-score")
                    preds.append(None)
                    continue
                preds.append(np.asarray(read_png(p),
                                        np.float32)[..., :3] / 255)
                if gt is None:
                    gp = p.parent / p.name.replace(SUFFIXES["pred"],
                                                   SUFFIXES["gt"])
                    if gp.exists():
                        gt = np.asarray(read_png(gp),
                                        np.float32)[..., :3] / 255
            if gt is None or all(p is None for p in preds):
                continue
            ncols = len(names) + 1
            fig, axes = plt.subplots(2, ncols, figsize=(3 * ncols, 6))
            axes[0, -1].imshow(gt)
            axes[0, -1].set_title("gt")
            for k, (name, pred) in enumerate(zip(names, preds)):
                if pred is None:
                    continue
                h = min(pred.shape[0], gt.shape[0])
                w = min(pred.shape[1], gt.shape[1])
                axes[0, k].imshow(pred)
                axes[0, k].set_title(f"{name}: {by_name[k][stem][metric]:.3f}")
                err = np.abs(pred[:h, :w] - gt[:h, :w]).mean(-1)
                axes[1, k].imshow(err, cmap="turbo", vmin=0, vmax=0.5)
                axes[1, k].set_title("L1 map")
            for ax in axes.ravel():
                ax.set_xticks([])
                ax.set_yticks([])
            fig.tight_layout()
            fig.savefig(outdir / f"diff_{metric}_{j}.png", dpi=100)
            plt.close(fig)


def compare_evaluations(report_dirs, names, outdir, n_examples: int = 3):
    """report_dirs: list of dirs containing detailed_report.json (and
    optionally examples.png + visualizations); names: model labels."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    outdir = Path(outdir)
    os.makedirs(outdir, exist_ok=True)
    reports = [load_detailed_report(d) for d in report_dirs]
    # only metrics present in EVERY report: models may have been scored
    # with different metric sets (e.g. one with LPIPS weights, one without)
    common = set(reports[0][0]) - {"path"}
    for rep in reports[1:]:
        common &= set(rep[0])
    metrics = [k for k in reports[0][0] if k in common]

    _violins(reports, names, metrics, outdir, plt)
    _example_sheets(reports, report_dirs, names, outdir, plt)
    _difference_plots(reports, names, report_dirs, metrics, outdir,
                      n_examples, plt)
    return outdir
