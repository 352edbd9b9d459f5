"""Score an existing prediction folder, or compare several evaluations (port
of diner_tpu.cli.eval_folder).

Behavioral reference: python_scripts/evaluate_prediction_folder.py:1-14
(re-score `<eval>/visualizations` in place) and the `compare_evaluations`
entry in src/evaluation/eval_suite.py:127-385 of malteprinzler/diner.

    # re-score a prediction folder (.../visualizations with *-pred/-gt pairs)
    python -m diner_tpu_torch.cli.eval_folder score <eval_dir> \\
        [--lpips WEIGHTS.npz] [--device cuda|cpu]

    # multi-model comparison report (violins, example sheets, diff plots)
    python -m diner_tpu_torch.cli.eval_folder compare OUT \\
        nameA=<evalA> nameB=<evalB> [--n-examples 3]

`score` writes the reports into <eval_dir>, as the reference's
evaluate_prediction_folder.py does; --lpips adds the LPIPS score (weights
from scripts/port_lpips.py; see nn/lpips.py), computed on the CUDA device
unless --device cpu. `compare` draws with matplotlib on the host, which the
card machine lacks.
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

    pc = sub.add_parser("compare")
    pc.add_argument("outdir")
    pc.add_argument("runs", nargs="+", help="name=<eval_dir> pairs")
    pc.add_argument("--n-examples", type=int, default=3)
    args = ap.parse_args(argv)

    if args.cmd == "compare":
        names, dirs = [], []
        for run in args.runs:
            name, _, d = run.partition("=")
            if not d:
                raise SystemExit(f"expected name=<eval_dir>, got {run!r}")
            names.append(name)
            dirs.append(Path(d))
        from diner_tpu_torch.eval.compare import compare_evaluations

        compare_evaluations(dirs, names, Path(args.outdir),
                            n_examples=args.n_examples)
        print(f"comparison written to {args.outdir}")
        return 0

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
