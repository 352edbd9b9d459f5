"""Where the time and the memory of a full-width training step go, on the
card.

    python -m diner_tpu_torch.profile_train [--config CONFIG.yaml]
        [--batch N] [--remat] [--steps N] [--profile-steps N] [--json PATH]

Builds DINER from the config's nerf, renderer and optimizer sections
(default configs/train_dtu.yaml: ResNet34 + group norm, ResnetFC 512x5 f32,
40 samples from 1000 candidates, VGG and antibias on 64x64 patches, Adam at
1e-4), random weights from seed 0, on synthetic 4-view 256x320 scenes, and
runs --steps train steps (batch --batch, `remat_field` with --remat), each
timed to its end on the card; then --profile-steps more under
torch.profiler. Prints the card, the TF32 settings, each step's seconds,
the median after the first two, the peak of torch.cuda.max_memory_allocated
over the timed steps, the device-busy share of the profiled steps (the union
of the device's kernel, copy and set intervals over their wall time), their
operators and kernels by device time, and the program's spans (calls, host
ms and stream ms in total and self) and counters (utils/profiling.py), each
per step; --json also writes them to PATH. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

CONFIG = (Path(__file__).resolve().parents[1] / "configs"
          / "train_dtu.yaml")
IMAGE, VIEWS, SCENES = (256, 320), 4, 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=str(CONFIG))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--profile-steps", type=int, default=0)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from diner_tpu_torch.cli.build import build_diner, optimizer_kwargs
    from diner_tpu_torch.core import resolve_device
    from diner_tpu_torch.core.config import load_config
    from diner_tpu_torch.data import SyntheticSphereDataset, collate
    from diner_tpu_torch.models.diner import to_tensors
    from diner_tpu_torch.train import create_train_state, train_step
    from diner_tpu_torch.train.loop import step_generator
    from diner_tpu_torch.utils.profiling import (card_name, device_tables,
                                                 print_report, print_tables,
                                                 report_json, tables_json,
                                                 take_report)

    dev = resolve_device("cuda")
    card = card_name()
    conf = load_config(args.config)
    if args.remat:
        conf["nerf"].setdefault("kwargs", {})["remat_field"] = True
    H, W = IMAGE
    torch.manual_seed(0)
    ds = SyntheticSphereDataset(n_scenes=SCENES, n_views=VIEWS, H=H, W=W,
                                seed=0)
    samples = [ds[i] for i in range(SCENES)]
    model = build_diner(conf, ds.znear, ds.zfar).to(dev)
    opt_kw = optimizer_kwargs(conf)
    state = create_train_state(model, opt_kw.pop("lr"), **opt_kw)

    def step(i):
        batch = collate([samples[(i * args.batch + j) % SCENES]
                         for j in range(args.batch)])
        out = train_step(state, to_tensors(batch, dev),
                         generator=step_generator(dev, 0, i))
        torch.cuda.synchronize()
        return out

    torch.cuda.reset_peak_memory_stats()
    seconds, totals = [], []
    for i in range(args.steps):
        t = time.perf_counter()
        totals.append(step(i)["total"])
        seconds.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated()
    steady = statistics.median(seconds[2:] or seconds)
    print(card)
    print(f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, cuDNN "
          f"{torch.backends.cudnn.allow_tf32}; batch {args.batch}, "
          f"remat_field {args.remat}, {H}x{W}, {VIEWS} views")
    print(f"steps {[round(s, 4) for s in seconds]} s; median after the "
          f"first two {steady:.4f} s/step = {1 / steady:.4f} steps/s; "
          f"totals {[round(t, 5) for t in totals]}; peak memory "
          f"{peak / 2 ** 30:.2f} GiB")
    result = {"card": card, "batch": args.batch, "remat_field": args.remat,
              "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
              "tf32_cudnn": torch.backends.cudnn.allow_tf32,
              "step_s": seconds, "steady_s_per_step": steady,
              "peak_memory_bytes": peak, "totals": totals}
    if args.profile_steps:
        wall = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(args.profile_steps):
                t = time.perf_counter()
                step(args.steps + i)
                wall.append(time.perf_counter() - t)
        report = take_report()
        operators, kernels, busy_us = device_tables(prof)
        n = args.profile_steps
        print(f"profiled steps {[round(w, 4) for w in wall]} s (profiler "
              f"on); device busy {busy_us / 1e6:.4f} s of {sum(wall):.4f} s "
              f"= {busy_us / 1e6 / sum(wall):.3f}")
        print_tables(operators, kernels, busy_us, n, "step", args.top)
        print_report(report, n, "step")
        result.update(profiled_step_s=wall, device_busy_s=busy_us / 1e6,
                      **tables_json(operators, kernels, n, "step"),
                      **report_json(report, n, "step"))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
