"""Job submission CLI: render or run the canonical cluster job specs (port
of diner_tpu.cli.submit).

The reference ships raw HTCondor submit files
(deps/TransMVSNet/condor_scripts/*.sub, process_dataset.sub); here the same
jobs are data (`diner_tpu_torch.cluster.specs`, on GPU nodes) rendered to
the scheduler in use:

    python -m diner_tpu_torch.cli.submit mvs-train-dtu --backend condor \
        --dir jobs/
    python -m diner_tpu_torch.cli.submit facescape-preprocess --backend jobset
    python -m diner_tpu_torch.cli.submit facescape-preprocess \
        --backend local --data /datasets --run

`--backend condor|jobset` writes the rendered file (and prints it with
--out -); `--backend local --run` executes the job here with the spec's
concurrency cap and retries.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

from diner_tpu_torch.cluster import SPECS, run_local, to_condor, to_jobset


def _resolve(spec, data: str, out: str):
    sub = lambda s: s.replace("{data}", data).replace("{out}", out)
    return dataclasses.replace(
        spec, command=[sub(c) for c in spec.command],
        array_file=sub(spec.array_file) if spec.array_file else None)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("spec", choices=sorted(SPECS))
    ap.add_argument("--backend", default="condor",
                    choices=("condor", "jobset", "local"))
    ap.add_argument("--data", default="data", help="dataset root ({data})")
    ap.add_argument("--out", default="outputs", help="output root ({out})")
    ap.add_argument("--dir", default="-",
                    help="where to write the rendered file; '-' = stdout")
    ap.add_argument("--run", action="store_true",
                    help="local backend: actually execute")
    ap.add_argument("--image", default="diner-tpu-torch:latest",
                    help="jobset backend: container image")
    args = ap.parse_args(argv)

    spec = _resolve(SPECS[args.spec], args.data, args.out)
    if args.backend == "condor":
        text, suffix = to_condor(spec), ".sub"
    elif args.backend == "jobset":
        import yaml

        text, suffix = yaml.safe_dump(to_jobset(spec, image=args.image),
                                      sort_keys=False), ".yaml"
    else:
        if not args.run:
            print(json.dumps(dataclasses.asdict(spec), indent=2, default=list))
            return 0
        results = run_local(spec)
        bad = {k: v for k, v in results.items() if v != 0}
        print(json.dumps({"done": len(results) - len(bad), "failed": bad}))
        return 1 if bad else 0

    if args.dir == "-":
        sys.stdout.write(text)
    else:
        path = Path(args.dir) / f"{spec.name}{suffix}"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        print(str(path))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
