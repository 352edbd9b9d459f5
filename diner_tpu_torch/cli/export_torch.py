"""Export the port's trained checkpoints to the reference's torch layouts
(port of diner_tpu.cli.export_torch).

A model trained with the port goes back to the reference's own tooling:
  diner: a Lightning-layout .ckpt whose state_dict DINER.load_from_checkpoint
         consumes (python_scripts/create_prediction_folder.py:41 in
         malteprinzler/diner; Lightning rebuilds the model from its hparams,
         so pass --hparams to embed a hyper_parameters dict),
  mvs:   the TransMVSNet {epoch, model} layout train.py:100-104 loads via
         --loadckpt / --resume.

The JAX package reads orbax directories; the port reads its own
checkpoints: `cli/train`'s `step_*.pt` ({"nerf", "optimizer", "scheduler",
"step"}, train/ckpt_io.py) and `cli/mvs train`'s ({"model", "optimizer",
"step"}, mvs/train.py); --ckpt takes the directory (the newest step) or one
file. The DINER model is rebuilt from --config, whose encoder must be
BatchNorm (the reference trunk's); the port's checkpoints carry no VGG
tower, so no vggloss entries are written.

    python -m diner_tpu_torch.cli.export_torch diner --ckpt runs/dtu/ckpts \\
        --config configs/train_dtu.yaml --znear 0.321 --zfar 1.204 \\
        --out diner_dtu.ckpt
    python -m diner_tpu_torch.cli.export_torch mvs --ckpt runs/mvs/ckpts \\
        --out transmvsnet.ckpt
"""

from __future__ import annotations

import argparse
import json

import torch


def _restore(ckpt):
    from diner_tpu_torch.train.ckpt_io import restore_latest

    payload, step = restore_latest(ckpt)
    if payload is None:
        raise SystemExit(f"no checkpoint found under {ckpt}")
    return payload, step


def cmd_diner(args):
    from diner_tpu_torch.cli.build import build_nerf
    from diner_tpu_torch.core.config import load_config
    from diner_tpu_torch.models.diner import DINER
    from diner_tpu_torch.models.lightning import to_lightning

    payload, step = _restore(args.ckpt)
    if "nerf" not in payload:
        raise SystemExit("the checkpoint has no 'nerf' state_dict: is this "
                         "a DINER training checkpoint? (MVS checkpoints "
                         "export through the `mvs` subcommand)")
    nerf = build_nerf(load_config(args.config)["nerf"])
    nerf.load_state_dict(payload["nerf"])
    sd = to_lightning(DINER(nerf, znear=args.znear, zfar=args.zfar))
    ckpt = {"state_dict": sd, "global_step": int(step), "epoch": 0}
    if args.hparams:
        ckpt["hyper_parameters"] = json.loads(args.hparams)
    torch.save(ckpt, args.out)
    print(f"wrote {args.out}: {len(sd)} tensors from step {step}")


def cmd_mvs(args):
    from diner_tpu_torch.mvs.checkpoint import to_reference_state_dict

    payload, step = _restore(args.ckpt)
    if "model" not in payload:
        raise SystemExit("the checkpoint has no 'model' state_dict: is this "
                         "an MVS training checkpoint?")
    sd = to_reference_state_dict(payload["model"])
    torch.save({"epoch": int(step), "model": sd}, args.out)
    print(f"wrote {args.out}: {len(sd)} tensors from step {step}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("diner", help="cli/train checkpoint -> Lightning .ckpt")
    d.add_argument("--ckpt", required=True,
                   help="checkpoint dir (newest step_*.pt) or file")
    d.add_argument("--out", required=True, help="output .ckpt path")
    d.add_argument("--znear", type=float, required=True,
                   help="scene near bound (the reference stores it as a "
                        "buffer; e.g. DTU 0.321, FaceScape 1.0)")
    d.add_argument("--zfar", type=float, required=True)
    d.add_argument("--config", required=True,
                   help="training YAML: the model (BatchNorm encoder) and "
                        "the poscode's num_freqs/freq_factor")
    d.add_argument("--hparams", default=None,
                   help="JSON dict embedded as hyper_parameters (Lightning "
                        "load_from_checkpoint rebuilds the model from it)")
    d.set_defaults(fn=cmd_diner)

    m = sub.add_parser("mvs", help="cli/mvs train checkpoint -> torch .ckpt")
    m.add_argument("--ckpt", required=True,
                   help="checkpoint dir (newest step_*.pt) or file")
    m.add_argument("--out", required=True)
    m.set_defaults(fn=cmd_mvs)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
