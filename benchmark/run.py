"""One run of one benchmark cell of diner_tpu_torch on the card.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Reads the cell from BENCHMARK.json at the checkout's root, its
configuration (`configs/<config>.json`) and its traffic mix
(`traffic/<traffic>.json`, whose `kind` names the generator in `lib/`),
makes the inputs and the weights from --seed, warms up the cell's shapes
(set-up), then measures for --seconds. With --trace 0 the result carries
the cell's end-to-end metrics; with --trace 1 the window runs under
torch.profiler and the result carries its per-layer metrics, each read by
`metrics/<name>.py`. After the window the outputs are compared with the
plain reference in `reference/` against the cell's limits
(`limits/<workload>.json`). The last line of standard output is the
result as JSON; the numbers compared, beside their limits, end standard
error. Exits non-zero, with no result, without a CUDA card, with fewer
cards than the cell asks for, or when JAX or the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / "build" / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "diner_tpu")

# every cache of the program and of torch inside the checkout, at fixed paths
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("USE_FLAX", "0")
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def load_json(path: Path):
    return json.loads(Path(path).read_text())


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _cell(bench: dict, workload: str):
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    config_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return cell, config_entry


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def read_metric(name: str, ctx: dict):
    """The per-layer metric `name` from metrics/<name>.py's read(ctx), or
    None where it finds nothing to read."""
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def generator_class(kind: str):
    mod = importlib.import_module(f"lib.{kind}")
    return getattr(mod, "GENERATOR")


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", bench: dict = None, overrides: dict = None,
             fault=None, t_start: float = None) -> dict:
    """One run of a cell -> the result dict. `bench` replaces
    BENCHMARK.json, `overrides` merges into the configuration (the tests'
    small sizes), `fault` breaks the program's timed path (the tests' planted
    faults)."""
    import torch

    from lib import common, trace as tracing

    t_start = T_START if t_start is None else t_start
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell, config_entry = _cell(bench, workload)
    config = common.merged(load_json(ROOT / config_entry["file"]),
                           overrides or {})
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{workload}.json")
    dev = torch.device(device)
    t_import = time.perf_counter()
    torch.zeros(1, device=dev)          # the device's context
    t_ready = time.perf_counter()

    gen = generator_class(traffic["kind"])(config, traffic, seed, dev,
                                           fault=fault)
    common.sync(dev)
    setup_s = time.perf_counter() - t_start
    phases = {"start": t_import - t_start, "context": t_ready - t_import,
              **gen.phases.seconds}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    window_s = gen.window(seconds)
    common.sync(dev)
    if prof is not None:
        prof.__exit__(None, None, None)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    e2e = gen.end_to_end(window_s, peak)
    e2e["setup_s"] = setup_s
    ctx = {"workload": workload, "config": config, "traffic": traffic,
           "window_s": window_s, "counts": gen.counts(),
           "spans": gen.clock.spans,
           "trace": tracing.reduce_profile(prof) if prof is not None
           else None}
    del prof
    attempted = gen.attempted
    gen.release()

    gaps = gen.check()
    checks = {k: {"value": gaps[k], "limit": v} for k, v in limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())

    metrics = {}
    if trace:
        for m in bench["per_layer"]:
            if _applies(m, workload):
                v = read_metric(m["name"], ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if _applies(m, workload):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": device_info(dev, peak)}
    if trace and ctx["trace"] is not None:
        t = ctx["trace"]
        result["device"]["busy_s"] = t.busy_ns / 1e9
        result["device"]["window_s"] = window_s
        result["breakdown"] = {"device_ops": [list(x) for x in t.top_ops],
                               "idle_gaps": [list(x) for x in t.idle_gaps]}
    result["setup_phases_s"] = phases
    result["checks"] = checks
    return result


def device_info(dev, peak: int) -> dict:
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": peak}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    cell, _ = _cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), bench=bench)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
