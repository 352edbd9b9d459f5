"""MVS CLI: train and finetune the TransMVSNet cascade, write the depth
priors the DINER readers consume, or run the cascade on the MVSNet eval
layout (port of diner_tpu.cli.mvs train, finetune, write and eval).

    python -m diner_tpu_torch.cli.mvs train --datapath ROOT --listfile LIST \
        --logdir RUN [--dataset dtu|facescape|multiface|bld] [--resume] \
        [--save-every N] [--max-steps N] [--device cuda|cpu]
    python -m diner_tpu_torch.cli.mvs finetune --datapath ROOT \
        --listfile LIST --logdir RUN [--torch-ckpt MODEL.ckpt]
    python -m diner_tpu_torch.cli.mvs write --datapath ROOT --listfile LIST \
        [--dataset dtu|facescape|multiface|bld] [--ckpt RUN/ckpts] \
        [--torch-ckpt MODEL.ckpt] [--device cuda|cpu]
    python -m diner_tpu_torch.cli.mvs eval --datapath ROOT --testlist SCANS \
        --outdir OUT [--ckpt RUN/ckpts] [--device cuda|cpu]

`train` minimizes the cascade's entropy loss (mvs/losses.py) with Adam and
the warmup-multistep schedule (mvs/train.py); `finetune` is the same with
the BlendedMVS loss and --dataset bld by default. Checkpoints go to
<logdir>/ckpts (weights, BatchNorm statistics, Adam's state, the step);
--resume continues from the latest. `write` runs the cascade (float32,
BatchNorm on running statistics) on each MVS sample and writes
<stem>_TransMVSNet.png, _conf.png and _vis.png next to the dataset's GT
depth path; DTU divides depth by 872/0.7 unless --scale says otherwise.
`eval` writes depth_est/*.pfm, confidence/*.pfm (the stage-3 confidence
times the upsampled stage-1 and stage-2 ones), cams/*_cam.txt and
images/*.png under OUT/<scan>/.

--ckpt restores the weights and BatchNorm statistics of this CLI's latest
checkpoint in a directory (or of one checkpoint file) and ignores the
optimizer; --torch-ckpt loads a reference TransMVSNet checkpoint, or one
that the JAX package's `export_torch mvs` wrote from its own training;
without either the weights are random from --seed. Every subcommand runs
on the CUDA device unless --device cpu is given, on one device.
Convolutions there run at torch's defaults, which let cuDNN use TF32.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F


def build_net(args, device):
    """The cascade of the CLI's architecture flags, weights from --ckpt,
    --torch-ckpt or random from --seed, in eval mode on `device`."""
    from diner_tpu_torch.mvs.checkpoint import load_reference_state_dict
    from diner_tpu_torch.mvs.net import TransMVSNet
    from diner_tpu_torch.train import ckpt_io

    kw = {}
    if args.cr_base_chs:
        kw["cr_base_chs"] = tuple(int(x) for x in args.cr_base_chs.split(","))
    if args.base_channels:
        kw["base_channels"] = int(args.base_channels)
    torch.manual_seed(args.seed)
    net = TransMVSNet(
        ndepths=tuple(int(x) for x in args.ndepths.split(",")),
        depth_intervals_ratio=tuple(float(x)
                                    for x in args.depth_inter_r.split(",")),
        **kw)
    if args.torch_ckpt:
        load_reference_state_dict(net, args.torch_ckpt)
    if getattr(args, "ckpt", None):
        restored, step = ckpt_io.restore_latest(args.ckpt)
        if restored is None:
            raise FileNotFoundError(f"no checkpoint under {args.ckpt}")
        load_reference_state_dict(net, restored["model"])
        print(f"restored the weights of step {step} from {args.ckpt}",
              flush=True)
    return net.to(device).eval()


def batch_of(sample, device):
    """One dataset sample -> the cascade's (imgs (1, V, 3, H, W),
    proj_matrices, depth_values (1, D)) on `device`."""
    from diner_tpu_torch.data.contract import collate
    from diner_tpu_torch.mvs.train import to_tensors

    return to_tensors(collate([sample]), device)


class _Concat:
    def __init__(self, parts):
        self.parts = [p for p in parts if len(p) > 0]

    def __len__(self):
        return sum(len(p) for p in self.parts)

    def __getitem__(self, idx):
        for p in self.parts:
            if idx < len(p):
                return p[idx]
            idx -= len(p)
        raise IndexError(idx)


def build_mvs_dataset(args, mode: str = "write_prediction"):
    """The samples of a subcommand, by --dataset: dtu and bld read
    (datapath, listfile) (DTU's corner cams, all 7 lights in "train" mode,
    light 3 otherwise); facescape and multiface re-use the DINER metas
    under datapath: FaceScape's train subjects for training and train and
    val for writing, MultiFace's train split for training and val for
    writing."""
    from diner_tpu_torch.mvs.datasets import (BlendedMVSDataset,
                                              DTUMVSDataset,
                                              FacescapeMVSDataset,
                                              MultifaceMVSDataset)

    name = args.dataset or "dtu"
    extra = json.loads(args.dataset_kwargs or "{}")
    if name in ("dtu", "bld"):
        cls = DTUMVSDataset if name == "dtu" else BlendedMVSDataset
        return cls(args.datapath, args.listfile, mode=mode,
                   ndepths=args.numdepth, **extra)
    if name == "facescape":
        stages = ("train",) if mode == "train" else ("train", "val")
        return _Concat([FacescapeMVSDataset(args.datapath, stage=s,
                                            ndepths=args.numdepth, **extra)
                        for s in stages])
    return MultifaceMVSDataset(args.datapath,
                               stage="train" if mode == "train" else "val",
                               ndepths=args.numdepth, **extra)


def _run(net, sample, device):
    with torch.inference_mode():
        return net(*batch_of(sample, device))


def cmd_write(args):
    """Write depth priors next to the dataset's GT depth paths. Returns the
    seconds each sample took (read, cascade and PNGs)."""
    from diner_tpu_torch.core.device import resolve_device
    from diner_tpu_torch.data.loader import process_local_slice
    from diner_tpu_torch.mvs.write_prediction import write_depth_prediction

    dev = resolve_device(args.device)
    ds = build_mvs_dataset(args)
    if args.scale is None:
        # DTU priors are written in TransMVSNet's training scale; the other
        # datasets' are metric
        args.scale = 872.0 / 0.7 if (args.dataset or "dtu") == "dtu" else 1.0
    net = build_net(args, dev)
    idxs = process_local_slice(len(ds))
    seconds = []
    for n, i in enumerate(idxs):
        t = time.perf_counter()
        s = ds[i]
        out = _run(net, s, dev)
        write_depth_prediction(out["depth"][0].cpu().numpy(),
                               out["photometric_confidence"][0].cpu().numpy(),
                               s["dpath"], scale=args.scale)
        seconds.append(time.perf_counter() - t)
        if n % 20 == 0:
            print(f"wrote {n + 1}/{len(idxs)}", flush=True)
    return seconds


def cmd_train(args, focal: bool = False):
    """Train (or, with focal, finetune) the cascade; returns mvs/train.py's
    per-step records."""
    from diner_tpu_torch.core.device import resolve_device
    from diner_tpu_torch.mvs.train import train

    dev = resolve_device(args.device)
    if focal and args.dataset is None:
        args.dataset = "bld"
    ds = build_mvs_dataset(args, "train")
    net = build_net(args, dev)
    epochs, factor = args.lrepochs.split(":")
    milestones = [int(float(e) * len(ds) / args.batch_size)
                  for e in epochs.split(",")]
    return train(net, ds, args.logdir, dev, lr=args.lr,
                 milestones=milestones, gamma=1.0 / float(factor),
                 dlossw=tuple(float(x) for x in args.dlossw.split(",")),
                 batch_size=args.batch_size, max_steps=args.max_steps,
                 log_every=args.log_every, save_every=args.save_every,
                 resume=args.resume, profile=args.profile, seed=args.seed,
                 focal=focal)


def eval_confidence(out):
    """The stage-3 confidence times the stage-1 and stage-2 ones, upsampled
    bilinearly to full resolution: (B, H, W)."""
    conf = out["photometric_confidence"]

    def up(c):
        return F.interpolate(c[:, None], size=conf.shape[-2:],
                             mode="bilinear", align_corners=False)[:, 0]

    return (conf * up(out["stage1"]["photometric_confidence"])
            * up(out["stage2"]["photometric_confidence"]))


def _read_testlist(testlist):
    p = Path(testlist)
    if p.exists():
        return [ln.strip() for ln in p.read_text().splitlines() if ln.strip()]
    return [s for s in testlist.split(",") if s]


def cmd_eval(args):
    """depth_est, confidence, cams and images per reference view under
    <outdir>/<scan>/. Returns the seconds each view took."""
    from diner_tpu_torch.core.device import resolve_device
    from diner_tpu_torch.data.codecs import write_mvsnet_cam, write_pfm
    from diner_tpu_torch.data.loader import process_local_slice
    from diner_tpu_torch.image_ops.png import write_png
    from diner_tpu_torch.mvs.datasets import GeneralEvalMVSDataset

    dev = resolve_device(args.device)
    ds = GeneralEvalMVSDataset(args.datapath, _read_testlist(args.testlist),
                               nviews=args.num_view, ndepths=args.numdepth,
                               interval_scale=args.interval_scale,
                               img_ext=args.img_ext)
    net = build_net(args, dev)
    out_root = Path(args.outdir)
    idxs = process_local_slice(len(ds))
    seconds = []
    for n, i in enumerate(idxs):
        t = time.perf_counter()
        s = ds[i]
        out = _run(net, s, dev)
        depth = out["depth"][0].cpu().numpy()
        conf = eval_confidence(out)[0].cpu().numpy()
        ref = int(s["view_ids"][0])
        scan_dir = out_root / s["scan"]
        for sub in ("depth_est", "confidence", "cams", "images"):
            (scan_dir / sub).mkdir(parents=True, exist_ok=True)
        write_pfm(scan_dir / "depth_est" / f"{ref:08d}.pfm", depth)
        write_pfm(scan_dir / "confidence" / f"{ref:08d}.pfm", conf)
        # the stage-3 cam: intrinsics at the prediction's resolution
        proj = s["proj_matrices"]["stage3"][0]
        dv = s["depth_values"]
        dint = float(dv[1] - dv[0]) if len(dv) > 1 else 1.0
        write_mvsnet_cam(scan_dir / "cams" / f"{ref:08d}_cam.txt",
                         proj[0], proj[1][:3, :3], float(dv[0]), dint)
        write_png(scan_dir / "images" / f"{ref:08d}.png",
                  (np.clip(s["imgs"][0], 0, 1) * 255).astype(np.uint8))
        seconds.append(time.perf_counter() - t)
        if n % 20 == 0:
            print(f"eval wrote {n + 1}/{len(idxs)}", flush=True)
    return seconds


def _arch_flags(p):
    p.add_argument("--ndepths", default="48,32,8")
    p.add_argument("--depth_inter_r", default="4,2,1")
    p.add_argument("--numdepth", type=int, default=192)
    p.add_argument("--cr_base_chs", default="",
                   help="cost-reg base channels, e.g. 8,8,8")
    p.add_argument("--base_channels", type=int, default=0,
                   help="FPN base channels override")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights without a checkpoint, "
                        "and of the training order")
    p.add_argument("--torch-ckpt", default=None,
                   help="a reference TransMVSNet checkpoint ({'model': "
                        "state_dict} or a bare state dict)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")


def _data_flags(p):
    p.add_argument("--datapath", required=True)
    p.add_argument("--listfile", required=True)
    p.add_argument("--dataset", default=None,
                   choices=("dtu", "facescape", "multiface", "bld"),
                   help="facescape and multiface re-use the DINER metas "
                        "under --datapath and ignore --listfile")
    p.add_argument("--dataset-kwargs", default=None,
                   help="JSON dict of extra dataset kwargs "
                        "(e.g. '{\"val_subjects\": [\"001\"]}')")


def parser():
    """The CLI's argument parser: the train, finetune, write and eval
    subcommands."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, text in (("train", "train the cascade"),
                       ("finetune", "finetune with the BlendedMVS loss "
                                    "(--dataset bld by default)")):
        pt = sub.add_parser(name, help=text)
        _data_flags(pt)
        pt.add_argument("--logdir", required=True)
        pt.add_argument("--profile", action="store_true",
                        help="a torch.profiler trace of steps 5-10 into "
                             "<logdir>/trace")
        pt.add_argument("--lr", type=float, default=1e-3)
        pt.add_argument("--lrepochs", default="10,12,14:2",
                        help="milestone epochs:decay divisor")
        pt.add_argument("--dlossw", default="0.5,1.0,2.0")
        pt.add_argument("--batch-size", type=int, default=1)
        pt.add_argument("--max-steps", type=int, default=1000)
        pt.add_argument("--log-every", type=int, default=20)
        pt.add_argument("--save-every", type=int, default=0,
                        help="checkpoint every N steps (0: at the end only)")
        pt.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint in "
                             "<logdir>/ckpts")
        _arch_flags(pt)

    pw = sub.add_parser("write", help="write depth priors")
    _data_flags(pw)
    pw.add_argument("--ckpt", default=None,
                    help="a checkpoint directory of `train` (its latest "
                         "step) or one checkpoint file")
    pw.add_argument("--scale", type=float, default=None,
                    help="depth divisor before writing; default 872/0.7 "
                         "for --dataset dtu, 1.0 (metric) for the others")
    _arch_flags(pw)

    pe = sub.add_parser("eval", help="depth, confidence, cams and images "
                                     "of the MVSNet eval layout")
    pe.add_argument("--datapath", required=True)
    pe.add_argument("--testlist", required=True,
                    help="scan-list file or comma-separated scan names")
    pe.add_argument("--outdir", required=True)
    pe.add_argument("--ckpt", default=None,
                    help="a checkpoint directory of `train` (its latest "
                         "step) or one checkpoint file")
    pe.add_argument("--num_view", type=int, default=5)
    pe.add_argument("--interval_scale", type=float, default=1.06)
    pe.add_argument("--img_ext", default=".jpg")
    _arch_flags(pe)
    return ap


def main(argv=None):
    """Run a subcommand; returns the per-step records of train and
    finetune, the seconds each sample took for write and eval."""
    args = parser().parse_args(argv)
    if args.cmd == "finetune":
        return cmd_train(args, focal=True)
    return {"train": cmd_train, "write": cmd_write,
            "eval": cmd_eval}[args.cmd](args)


if __name__ == "__main__":
    main()
