"""Where the time of one full-width request goes, on the card.

    python -m diner_tpu_torch.profile_serve [--requests N] [--json PATH]
        [--likelihood {v1,chord}]

Builds the RenderServer of chip_smoke.py's serve phase (the fast DTU preset
from configs/evaluate_diner_on_dtu_fast.yaml, random weights from seed 0, a
synthetic 4-view 256x320 scene) on the given likelihood route (the preset's
"v1", kernel K1, or "chord", kernel K3), warms it up with one request, then
runs N requests under torch.profiler. Prints the card, each request's wall time,
the device-busy share (the union of the device's kernel, copy and set
intervals over the wall time), the operators and the kernels by device time,
and the program's spans (calls, host ms and stream ms in total and self) and
counters (utils/profiling.py), each per request; --json also writes them to
PATH. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

PRESET = (Path(__file__).resolve().parents[1] / "configs"
          / "evaluate_diner_on_dtu_fast.yaml")
IMAGE, VIEWS = (256, 320), 4   # the DTU evaluation size and source views


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--json", default=None)
    ap.add_argument("--likelihood", choices=("v1", "chord"), default="v1")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from diner_tpu_torch.core import resolve_device
    from diner_tpu_torch.data import SyntheticSphereDataset
    from diner_tpu_torch.serve import RenderServer
    from diner_tpu_torch.utils.profiling import (card_name, device_tables,
                                                 print_report, print_tables,
                                                 report_json, tables_json,
                                                 take_report)

    resolve_device("cuda")
    card = card_name()
    H, W = IMAGE
    torch.manual_seed(0)
    ds = SyntheticSphereDataset(n_scenes=1, n_views=VIEWS, H=H, W=W, seed=0)
    s = ds[0]
    server = RenderServer.from_preset(PRESET, None, ds.znear, ds.zfar,
                                      buckets=((H, W),))
    server.cfg = dataclasses.replace(server.cfg, likelihood=args.likelihood)
    server.load_scene("scene0", *(s[k][None] for k in (
        "src_rgbs", "src_depths", "src_depth_stds", "src_extrinsics",
        "src_intrinsics")))

    def request(i):
        server.render("scene0", s["target_extrinsics"][None],
                      s["target_intrinsics"][None], H, W, seed=i)
        torch.cuda.synchronize()

    request(0)  # warm-up: cuDNN/cuBLAS selection, kernel builds
    wall = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(args.requests):
            t = time.perf_counter()
            request(i + 1)
            wall.append(time.perf_counter() - t)

    report = take_report()
    operators, kernels, busy_us = device_tables(prof)
    wall_s = sum(wall)
    n = args.requests
    print(card)
    print(f"likelihood route {args.likelihood}")
    print(f"requests {[round(w, 4) for w in wall]} s at {H}x{W} "
          f"(profiler on); device busy {busy_us / 1e6:.4f} s of "
          f"{wall_s:.4f} s = {busy_us / 1e6 / wall_s:.3f}")
    print_tables(operators, kernels, busy_us, n, "request", args.top)
    print_report(report, n, "request")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "likelihood": args.likelihood,
                       "requests_s": wall,
                       "device_busy_s": busy_us / 1e6,
                       **tables_json(operators, kernels, n, "request"),
                       **report_json(report, n, "request")},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
