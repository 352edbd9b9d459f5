"""base6k's initial weights in both packages, on the CPU.

    python scripts/base6k_init_check.py inits --seeds 0-63 --out DIR
    python scripts/base6k_init_check.py stats --seeds 0-31 --inits DIR \
        [--json OUT.json]

`inits` builds the JAX package's DINER at configs/plateau/base6k.yaml's
widths with `create_train_state` at PRNGKey(s), as its `cli/train --seed s`
does, carries the weights to the port's names through `models/from_jax.py`
and writes DIR/jax_<s>.pt, a step-0 checkpoint of the port's trainer
({"nerf": state_dict, "step": 0}). Copied into a run directory's ckpts/,
`python -m diner_tpu_torch.cli.train CONFIG --run-dir D --resume` trains
from JAX's initial weights on the port's own draws
(scripts/base6k_counts.py).

`stats` builds the port's init at each seed as its `cli/train --seed s`
does (torch.manual_seed(s), the datasets, then `build_diner`), loads JAX's
from DIR, and runs both through the port's forward on one fixed batch of
base6k's training data with one fixed draw. Per seed and init it records
the field's pre-activation rgb and sigma (ResnetFC's output before the
sigmoid and softplus: mean and std over all samples) and the rendered rgb
mean, then prints each statistic's mean over seeds with its standard
error, for each init, and the paired difference.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
CONFIG = str(ROOT / "configs/plateau/base6k.yaml")


def _seeds(spec: str):
    lo, _, hi = spec.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def make_jax_inits(seeds, out: Path):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from diner_tpu.cli.build import build_dataset, build_diner
    from diner_tpu.core.config import load_config
    from diner_tpu.data import collate, to_device_batch
    from diner_tpu.train.state import create_train_state
    from diner_tpu_torch.models import from_jax

    conf = load_config(CONFIG)
    ds = build_dataset(conf["data"]["train"], stage="train")
    model = build_diner(conf, znear=ds.znear, zfar=ds.zfar)
    batch = to_device_batch(collate([ds[0], ds[1]]))
    out.mkdir(parents=True, exist_ok=True)
    for s in seeds:
        state = create_train_state(model, jax.random.PRNGKey(s), batch)
        variables = {"params": state.params}
        if state.batch_stats:
            variables["batch_stats"] = state.batch_stats
        sd = from_jax(jax.device_get(variables))
        nerf = {k[len("nerf."):]: v for k, v in sd.items()
                if k.startswith("nerf.")}
        torch.save({"nerf": nerf, "step": 0}, out / f"jax_{s}.pt")
        print(f"seed {s}: {len(nerf)} tensors", flush=True)


def _port_model(seed):
    from diner_tpu_torch.cli.build import build_dataset, build_diner
    from diner_tpu_torch.core.config import load_config

    conf = load_config(CONFIG)
    torch.manual_seed(seed)
    train_set = build_dataset(conf["data"]["train"], stage="train")
    build_dataset(conf["data"]["val"], stage="val")
    return build_diner(conf, znear=train_set.znear, zfar=train_set.zfar), \
        train_set


def _forward_stats(model, batch):
    """Pre-activation field statistics and the rendered rgb mean of one
    forward with a fixed draw."""
    import diner_tpu_torch.models.diner as dmod

    pre, rendered = [], []
    hook = model.nerf.mlp.register_forward_hook(
        lambda m, i, o: pre.append(o.detach()))
    real = dmod.render_rays

    def spy(*a, **k):
        out = real(*a, **k)
        rendered.append(out["rgb"].detach())
        return out

    dmod.render_rays = spy
    try:
        with torch.no_grad():
            model.losses(batch, train=True,
                         generator=torch.Generator().manual_seed(12345))
    finally:
        dmod.render_rays = real
        hook.remove()
    out = torch.cat([p.reshape(-1, 4) for p in pre])
    return {"rgb_pre_mean": float(out[:, :3].mean()),
            "rgb_pre_std": float(out[:, :3].std()),
            "sigma_pre_mean": float(out[:, 3].mean()),
            "sigma_pre_std": float(out[:, 3].std()),
            "rgb_render_mean": float(rendered[-1].mean())}


def init_stats(seeds, inits: Path, json_out=None):
    from diner_tpu_torch.data import collate
    from diner_tpu_torch.models.diner import to_tensors

    torch.set_num_threads(4)
    rows = []
    batch = None
    for s in seeds:
        model, train_set = _port_model(s)
        if batch is None:
            batch = to_tensors(collate([train_set[0], train_set[1]]), "cpu")
        port = _forward_stats(model, batch)
        model.nerf.load_state_dict(torch.load(inits / f"jax_{s}.pt",
                                              weights_only=True)["nerf"])
        jax_ = _forward_stats(model, batch)
        rows.append({"seed": s, "port": port, "jax": jax_})
        print(json.dumps(rows[-1]), flush=True)
    keys = list(rows[0]["port"])
    summary = {}
    print(f"{'statistic':18s} {'port':>22s} {'jax':>22s} {'port - jax':>22s}")
    for k in keys:
        p = np.array([r["port"][k] for r in rows])
        j = np.array([r["jax"][k] for r in rows])
        n = len(rows)
        cell = {name: (float(v.mean()), float(v.std(ddof=1) / np.sqrt(n)))
                for name, v in (("port", p), ("jax", j), ("diff", p - j))}
        summary[k] = cell
        print(f"{k:18s} " + " ".join(
            f"{m:+.5f} +- {se:.5f}".rjust(22) for m, se in cell.values()))
    if json_out:
        Path(json_out).write_text(json.dumps(
            {"rows": rows, "summary": summary}, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=["inits", "stats"])
    ap.add_argument("--seeds", default="0-31")
    ap.add_argument("--out", default="build/base6k_inits")
    ap.add_argument("--inits", default="build/base6k_inits")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if args.what == "inits":
        make_jax_inits(_seeds(args.seeds), Path(args.out))
    else:
        init_stats(_seeds(args.seeds), Path(args.inits), args.json)


if __name__ == "__main__":
    main()
