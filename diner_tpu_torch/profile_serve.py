"""Where the time of one full-width request goes, on the card.

    python -m diner_tpu_torch.profile_serve [--requests N] [--json PATH]
        [--likelihood {v1,chord}]

Builds the RenderServer of chip_smoke.py's serve phase (the fast DTU preset
from configs/evaluate_diner_on_dtu_fast.yaml, random weights from seed 0, a
synthetic 4-view 256x320 scene) on the given likelihood route (the preset's
"v1", kernel K1, or "chord", kernel K3), warms it up with one request, then
runs N requests under torch.profiler. Prints the card, each request's wall time,
the device-busy share (the summed device time of all kernels over the wall
time), and the operators and the kernels by device time; --json also writes
them to PATH. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diner_tpu_torch.core import resolve_device
    from diner_tpu_torch.data import SyntheticSphereDataset
    from diner_tpu_torch.serve import RenderServer

    resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
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

    def device_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))

    # kernel rows (device events) carry the device time once; operator rows
    # (aten::*) carry the time of the kernels they launched
    rows = [(e.key, device_us(e), e.count, e.device_type == DeviceType.CUDA)
            for e in prof.key_averages()]
    kernels = sorted((r for r in rows if r[3] and r[1] > 0),
                     key=lambda r: -r[1])
    operators = sorted((r for r in rows if not r[3] and r[1] > 0),
                       key=lambda r: -r[1])
    busy_us = sum(r[1] for r in kernels)
    wall_s = sum(wall)
    n = args.requests
    print(card)
    print(f"likelihood route {args.likelihood}")
    print(f"requests {[round(w, 4) for w in wall]} s at {H}x{W} "
          f"(profiler on); device busy {busy_us / 1e6:.4f} s of "
          f"{wall_s:.4f} s = {busy_us / 1e6 / wall_s:.3f}")
    for title, table in (("operators", operators), ("kernels", kernels)):
        print(f"{title}: device ms/request, share of busy, calls/request")
        for key, us, count, _ in table[:args.top]:
            print(f"{us / 1e3 / n:10.3f} {us / busy_us:6.3f} "
                  f"{count / n:7.1f}  {key[:100]}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "likelihood": args.likelihood,
                       "requests_s": wall,
                       "device_busy_s": busy_us / 1e6,
                       **{title: [{"name": k, "device_ms_per_request":
                                   us / 1e3 / n, "calls_per_request": c / n}
                                  for k, us, c, _ in table]
                          for title, table in (("operators", operators),
                                               ("kernels", kernels))}},
                      f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
