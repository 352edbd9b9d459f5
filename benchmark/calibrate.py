"""Readings that set a cell's limits (benchmark/limits/<workload>.json).

    python3 benchmark/calibrate.py --workload NAME --seeds 11,12,13
        [--seconds S] [--control] [--fault NAME] [--json PATH]

For each seed, in one process: the cell's set-up, a window of --seconds at
the cell's own load, and the check against the plain reference, which
gives the program's readings (the lower ones); with --control also the
readings of each of the configuration's controls, the reference in a lower
precision put in the program's place (the upper ones); with --fault, the program with that
fault of lib/faults.py planted instead. Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import run  # noqa: F401  (sets the caches and the import path)
from lib import common, faults


def readings(workload: str, seed: int, seconds: float, control: bool,
             fault: str = None, device="cuda", overrides=None) -> dict:
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell, entry = run._cell(bench, workload)
    config = common.merged(run.load_json(run.ROOT / entry["file"]),
                           overrides or {})
    traffic = run.load_json(run.BENCH / "traffic" / f"{cell['traffic']}.json")
    t = time.perf_counter()
    gen = run.generator_class(traffic["kind"])(
        config, traffic, seed, device,
        fault=faults.FAULTS[fault] if fault else None)
    setup_s = time.perf_counter() - t
    window_s = gen.window(seconds)
    out = {"workload": workload, "seed": seed, "fault": fault,
           "attempted": gen.attempted, "setup_s": setup_s,
           "window_s": window_s}
    gen.release()
    t = time.perf_counter()
    out["program"] = gen.check()
    out["check_s"] = time.perf_counter() - t
    if control:
        out["controls"] = gen.control_check()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=sorted(faults.FAULTS), default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    lines = []
    for s in args.seeds.split(","):
        r = readings(args.workload, int(s), args.seconds, args.control,
                     args.fault)
        print(json.dumps(r), flush=True)
        lines.append(r)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text("\n".join(json.dumps(r) for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
