"""MVS inference CLI: write the TransMVSNet depth priors the DINER readers
consume, or run the cascade on the MVSNet eval layout (port of
diner_tpu.cli.mvs write and eval).

    python -m diner_tpu_torch.cli.mvs write --datapath ROOT --listfile LIST \
        [--dataset dtu|facescape|multiface] [--torch-ckpt MODEL.ckpt] \
        [--device cuda|cpu]
    python -m diner_tpu_torch.cli.mvs eval --datapath ROOT --testlist SCANS \
        --outdir OUT [--torch-ckpt MODEL.ckpt] [--device cuda|cpu]

`write` runs the cascade (float32, BatchNorm on running statistics) on each
MVS sample and writes <stem>_TransMVSNet.png, _conf.png and _vis.png next
to the dataset's GT depth path; DTU divides depth by 872/0.7 unless
--scale says otherwise. `eval` writes depth_est/*.pfm, confidence/*.pfm
(the stage-3 confidence times the upsampled stage-1 and stage-2 ones),
cams/*_cam.txt and images/*.png under OUT/<scan>/.

--torch-ckpt loads a reference TransMVSNet checkpoint, or one that the JAX
package's `export_torch mvs` wrote from its own training; without it the
weights are random from --seed. Both run on the CUDA device unless
--device cpu is given. Convolutions there run at torch's defaults, which
let cuDNN use TF32.
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
    """The cascade of the CLI's architecture flags, weights from
    --torch-ckpt or random from --seed, in eval mode on `device`."""
    from diner_tpu_torch.mvs.checkpoint import load_reference_state_dict
    from diner_tpu_torch.mvs.net import TransMVSNet

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
    return net.to(device).eval()


def batch_of(sample, device):
    """One dataset sample -> the cascade's (imgs (1, V, 3, H, W),
    proj_matrices, depth_values (1, D)) on `device`."""
    imgs = torch.from_numpy(np.ascontiguousarray(sample["imgs"], np.float32))
    projs = {k: torch.from_numpy(np.asarray(v, np.float32))[None].to(device)
             for k, v in sample["proj_matrices"].items()}
    dvals = torch.from_numpy(np.asarray(sample["depth_values"], np.float32))
    return (imgs.permute(0, 3, 1, 2)[None].contiguous().to(device), projs,
            dvals[None].to(device))


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


def build_mvs_dataset(args):
    """The samples `write` runs on, by --dataset: dtu reads (datapath,
    listfile), its corner cams at light 3; facescape and multiface re-use
    the DINER metas under datapath: FaceScape's train and val subjects
    both, MultiFace's val split."""
    from diner_tpu_torch.mvs.datasets import (DTUMVSDataset,
                                              FacescapeMVSDataset,
                                              MultifaceMVSDataset)

    name = args.dataset or "dtu"
    extra = json.loads(args.dataset_kwargs or "{}")
    if name == "dtu":
        return DTUMVSDataset(args.datapath, args.listfile,
                             mode="write_prediction", ndepths=args.numdepth,
                             **extra)
    if name == "facescape":
        return _Concat([FacescapeMVSDataset(args.datapath, stage=s,
                                            ndepths=args.numdepth, **extra)
                        for s in ("train", "val")])
    return MultifaceMVSDataset(args.datapath, stage="val",
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
        # DTU priors are written in TransMVSNet's training scale; the face
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
                   help="seed of the random weights without --torch-ckpt")
    p.add_argument("--torch-ckpt", default=None,
                   help="a reference TransMVSNet checkpoint ({'model': "
                        "state_dict} or a bare state dict)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")


def parser():
    """The CLI's argument parser: the write and eval subcommands."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    pw = sub.add_parser("write", help="write depth priors")
    pw.add_argument("--datapath", required=True)
    pw.add_argument("--listfile", required=True)
    pw.add_argument("--dataset", default=None,
                    choices=("dtu", "facescape", "multiface"),
                    help="facescape and multiface re-use the DINER metas "
                         "under --datapath and ignore --listfile")
    pw.add_argument("--dataset-kwargs", default=None,
                    help="JSON dict of extra dataset kwargs "
                         "(e.g. '{\"val_subjects\": [\"001\"]}')")
    pw.add_argument("--scale", type=float, default=None,
                    help="depth divisor before writing; default 872/0.7 "
                         "for --dataset dtu, 1.0 (metric) for the faces")
    _arch_flags(pw)

    pe = sub.add_parser("eval", help="depth, confidence, cams and images "
                                     "of the MVSNet eval layout")
    pe.add_argument("--datapath", required=True)
    pe.add_argument("--testlist", required=True,
                    help="scan-list file or comma-separated scan names")
    pe.add_argument("--outdir", required=True)
    pe.add_argument("--num_view", type=int, default=5)
    pe.add_argument("--interval_scale", type=float, default=1.06)
    pe.add_argument("--img_ext", default=".jpg")
    _arch_flags(pe)
    return ap


def main(argv=None):
    """Run a subcommand; returns the seconds each sample took."""
    args = parser().parse_args(argv)
    return {"write": cmd_write, "eval": cmd_eval}[args.cmd](args)


if __name__ == "__main__":
    main()
