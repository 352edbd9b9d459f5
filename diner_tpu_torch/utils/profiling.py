"""Shared pieces of the profiling entry points (profile_serve,
profile_train): the card's name and power limit, and the operator and
kernel tables of a torch.profiler run by device time."""

from __future__ import annotations

import subprocess


def card_name() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def device_tables(prof):
    """(operators, kernels, busy_us) of a finished torch.profiler run: rows
    (name, device us, calls) by device time, descending. Kernel rows
    (device events) carry each kernel's time once; operator rows (aten::*)
    carry the time of the kernels they launched. busy_us sums the
    kernels."""
    from torch.autograd import DeviceType

    def device_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))

    rows = [(e.key, device_us(e), e.count, e.device_type == DeviceType.CUDA)
            for e in prof.key_averages()]
    kernels = sorted(((k, us, c) for k, us, c, dev in rows
                      if dev and us > 0), key=lambda r: -r[1])
    operators = sorted(((k, us, c) for k, us, c, dev in rows
                        if not dev and us > 0), key=lambda r: -r[1])
    return operators, kernels, sum(r[1] for r in kernels)


def print_tables(operators, kernels, busy_us, n: int, unit: str, top: int):
    """Print both tables per `unit` (request, step) over n of them."""
    for title, table in (("operators", operators), ("kernels", kernels)):
        print(f"{title}: device ms/{unit}, share of busy, calls/{unit}")
        for key, us, count in table[:top]:
            print(f"{us / 1e3 / n:10.3f} {us / busy_us:6.3f} "
                  f"{count / n:7.1f}  {key[:100]}")


def tables_json(operators, kernels, n: int, unit: str):
    return {title: [{"name": k, f"device_ms_per_{unit}": us / 1e3 / n,
                     f"calls_per_{unit}": c / n} for k, us, c in table]
            for title, table in (("operators", operators),
                                 ("kernels", kernels))}
