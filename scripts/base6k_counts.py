"""Count base6k's black runs on a card with TF32 off.

    python scripts/base6k_counts.py --seeds 0-63 --init port \
        [--inits DIR] [--parallel 4] [--steps 60] [--json OUT.json]

Runs, for each seed s, the port's trainer as

    python -m diner_tpu_torch.cli.train configs/plateau/base6k.yaml \
        --run-dir D --max-steps 60 --seed s --log-every 10

with TF32 off for cuDNN and for matmuls, `--parallel` runs at once, each
validating at its last step. With `--init jax` each run starts from
DIR/jax_<s>.pt (JAX's initial weights at PRNGKey(s), written by
scripts/base6k_init_check.py inits), placed as the run's step-0
checkpoint and restored by `--resume`; the draws are the port's own at
the seed either way, so the two inits of a seed train on the same draws.
A run is black when its validation reads the black render's 17.30 dB /
0.0318 SSIM. Prints and writes one JSON record per run and the count.

    python scripts/base6k_counts.py --summarize PORT.json JAX.json ...

pairs the runs of the given --json files by seed (port init against JAX
init), prints each seed's outcomes, both counts, the discordant pairs and
the exact two-sided sign test on them.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONFIG = "configs/plateau/base6k.yaml"


def _child(argv):
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    from diner_tpu_torch.cli.train import main

    main(argv)


def _scores(run_dir: Path, step: int):
    for line in (run_dir / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec.get("step") == step and "valscores_psnr" in rec:
            return rec["valscores_psnr"], rec["valscores_ssim"]
    return None, None


def is_black(psnr, ssim) -> bool:
    return (psnr is not None and round(psnr, 2) == 17.30
            and round(ssim, 4) == 0.0318)


def sign_test(a: int, b: int) -> float:
    """Exact two-sided binomial p of a split a:b of discordant pairs."""
    from math import comb

    n, k = a + b, min(a, b)
    if n == 0:
        return 1.0
    return min(1.0, 2 * sum(comb(n, i) for i in range(k + 1)) / 2 ** n)


def summarize(paths):
    runs = {"port": {}, "jax": {}}
    for p in paths:
        for r in json.loads(Path(p).read_text())["runs"]:
            runs[r["init"]][r["seed"]] = r
    seeds = sorted(set(runs["port"]) & set(runs["jax"]))
    port_only = [s for s in seeds if runs["port"][s]["black"]
                 and not runs["jax"][s]["black"]]
    jax_only = [s for s in seeds if runs["jax"][s]["black"]
                and not runs["port"][s]["black"]]
    out = {"seeds": len(seeds),
           "port_black": sum(runs["port"][s]["black"] for s in seeds),
           "jax_black": sum(runs["jax"][s]["black"] for s in seeds),
           "port_only_black": port_only, "jax_only_black": jax_only,
           "both_black": [s for s in seeds if runs["port"][s]["black"]
                          and runs["jax"][s]["black"]],
           "sign_test_p": sign_test(len(port_only), len(jax_only)),
           "failed": [s for s in seeds if runs["port"][s]["rc"]
                      or runs["jax"][s]["rc"]]}
    for s in seeds:
        print(f"seed {s:3d}: port "
              f"{'black' if runs['port'][s]['black'] else 'escapes'} "
              f"({runs['port'][s]['psnr']:.2f} dB / "
              f"{runs['port'][s]['ssim']:.4f}), jax "
              f"{'black' if runs['jax'][s]['black'] else 'escapes'} "
              f"({runs['jax'][s]['psnr']:.2f} dB / "
              f"{runs['jax'][s]['ssim']:.4f})")
    print(json.dumps(out))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0-63")
    ap.add_argument("--init", choices=["port", "jax"], default="port")
    ap.add_argument("--inits", default="build/base6k_inits")
    ap.add_argument("--workdir", default="build/base6k_runs")
    ap.add_argument("--parallel", type=int, default=4)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--summarize", nargs="+", default=None,
                    help="the --json files of earlier runs")
    ap.add_argument("--child", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.child is not None:
        return _child(args.child)
    if args.summarize:
        summarize(args.summarize)
        return 0

    lo, _, hi = args.seeds.partition("-")
    seeds = list(range(int(lo), int(hi or lo) + 1))
    work = Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    pending = list(seeds)
    running = {}
    records = []
    t0 = time.time()
    while pending or running:
        while pending and len(running) < args.parallel:
            s = pending.pop(0)
            run_dir = work / f"{args.init}_{s}"
            shutil.rmtree(run_dir, ignore_errors=True)
            cli = [CONFIG, "--run-dir", str(run_dir), "--max-steps",
                   str(args.steps), "--seed", str(s), "--log-every", "10",
                   "--device", args.device]
            if args.init == "jax":
                (run_dir / "ckpts").mkdir(parents=True)
                shutil.copy(Path(args.inits) / f"jax_{s}.pt",
                            run_dir / "ckpts" / "step_00000000.pt")
                cli.append("--resume")
            log = open(work / f"{args.init}_{s}.log", "w")
            proc = subprocess.Popen(
                [sys.executable, __file__, "--child", *cli], cwd=ROOT,
                stdout=log, stderr=subprocess.STDOUT,
                env=dict(os.environ, PYTHONUNBUFFERED="1"))
            running[s] = (proc, run_dir, log, time.time())
        time.sleep(0.5)
        for s in [s for s, (p, *_) in running.items() if p.poll() is not None]:
            proc, run_dir, log, ts = running.pop(s)
            log.close()
            psnr, ssim = _scores(run_dir, args.steps) if proc.returncode == 0 \
                else (None, None)
            rec = {"seed": s, "init": args.init, "rc": proc.returncode,
                   "psnr": psnr, "ssim": ssim, "black": is_black(psnr, ssim),
                   "s": round(time.time() - ts, 1)}
            records.append(rec)
            print(json.dumps(rec), flush=True)
            shutil.rmtree(run_dir / "ckpts", ignore_errors=True)
    records.sort(key=lambda r: r["seed"])
    failed = [r["seed"] for r in records if r["rc"] != 0]
    black = [r["seed"] for r in records if r["black"]]
    summary = {"init": args.init, "seeds": seeds, "black": black,
               "n_black": len(black), "n": len(records), "failed": failed,
               "seconds": round(time.time() - t0, 1)}
    print(json.dumps(summary), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"summary": summary, "runs": records}, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
