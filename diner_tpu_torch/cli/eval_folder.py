"""Score an existing prediction folder (port of the `score` subcommand of
diner_tpu.cli.eval_folder; `compare` is not ported yet).

    python -m diner_tpu_torch.cli.eval_folder score <eval_dir> \\
        [--lpips WEIGHTS.npz] [--device cuda|cpu]

re-scores `<eval_dir>/visualizations` (the *-pred/-gt pairs) and writes the
reports into <eval_dir>, as the reference's evaluate_prediction_folder.py
does. --lpips adds the LPIPS score (weights from scripts/port_lpips.py; see
nn/lpips.py), computed on the CUDA device unless --device cpu.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("score")
    ps.add_argument("eval_dir", help="dir containing visualizations/")
    ps.add_argument("--lpips", default=None,
                    help="LPIPS-VGG weights (.npz; scripts/port_lpips.py)")
    ps.add_argument("--device", default="cuda",
                    help="where LPIPS runs: cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from diner_tpu_torch.eval.suite import evaluate_folder

    lpips_fn = None
    if args.lpips:
        from diner_tpu_torch.nn.lpips import load_lpips_npz, make_lpips_fn

        lpips_fn = make_lpips_fn(load_lpips_npz(args.lpips), args.device)
    eval_dir = Path(args.eval_dir)
    scores = evaluate_folder(eval_dir / "visualizations", eval_dir,
                             lpips_fn=lpips_fn)
    for k, v in sorted(scores.items()):
        print(f"{k}: {v:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
