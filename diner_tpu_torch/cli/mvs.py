"""MVS CLI: train and finetune the TransMVSNet cascade, write the depth
priors the DINER readers consume, run the cascade on the MVSNet eval
layout, or fuse its outputs into point clouds (port of diner_tpu.cli.mvs
train, finetune, write, eval and fuse).

    python -m diner_tpu_torch.cli.mvs train --datapath ROOT --listfile LIST \
        --logdir RUN [--dataset dtu|facescape|multiface|bld] [--resume] \
        [--save-every N] [--max-steps N] [--device cuda|cpu] \
        [--multihost [--coordinator HOST:PORT] [--num-processes N] \
         [--process-id I]]
    python -m diner_tpu_torch.cli.mvs finetune --datapath ROOT \
        --listfile LIST --logdir RUN [--torch-ckpt MODEL.ckpt]
    python -m diner_tpu_torch.cli.mvs write --datapath ROOT --listfile LIST \
        [--dataset dtu|facescape|multiface|bld] [--ckpt RUN/ckpts] \
        [--torch-ckpt MODEL.ckpt] [--data-parallel] [--device cuda|cpu]
    python -m diner_tpu_torch.cli.mvs eval --datapath ROOT --testlist SCANS \
        --outdir OUT [--ckpt RUN/ckpts] [--data-parallel] [--device cuda|cpu]
    python -m diner_tpu_torch.cli.mvs fuse --datapath ROOT --testlist SCANS \
        --outdir OUT [--method normal|dynamic|consensus] [--device cuda|cpu]

Every subcommand but fuse takes --compute-dtype float32|bfloat16 and
--dcn-impl gather|window with --dcn-window-check warn|fallback|off (see
below).

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
on the CUDA device unless --device cpu is given. Convolutions there run at
torch's defaults, which let cuDNN use TF32.

--compute-dtype bfloat16 runs the convs, DCN heads, FMT and cost volumes
in bfloat16 on float32 parameters (geometry, offsets, softmax and WTA in
float32). --dcn-impl window swaps the DCN heads to the gather-free stencil,
exact while every tap's |k + offset| < 2 - 1e-3 and with the same
checkpoints; before write, eval and training it audits the first sample's
offsets (`mvs.net.window_offset_stats`) and, past the window, warns
(--dcn-window-check warn, the default), rebuilds the net with the gather
DCN (fallback) or does nothing (off).

--data-parallel on write and eval runs one sample on each local card at a
time, each on its own replica, the last group padded with its last sample
as the JAX package pads its batch; with one card it runs as without it.
train and finetune --multihost train data-parallel over torch.distributed,
one process a card (NCCL; gloo with --device cpu), with torchrun's
variables or the flags, as `cli/train --multihost` does: --batch-size is
each rank's, the --lrepochs milestones count steps of the global batch,
BatchNorm is synced over the global batch, rank 0 alone writes
checkpoints and the ranks share --logdir.

`fuse` reads eval's outputs under OUT/<scan>/ and ROOT/<scan>/pair.txt,
filters and fuses the depth maps (`normal`: each reference view against its
pair list's sources; `dynamic`: progressive thresholds; `consensus`:
fusibile's method) and writes OUT/mvsnet<NNN>_l3.ply for a DTU scan
("scan<NNN>"), else OUT/<scan>.ply.
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from concurrent.futures import ThreadPoolExecutor
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
        compute_dtype=args.compute_dtype, dcn_impl=args.dcn_impl, **kw)
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


def check_window_dcn(net, ds, args, device):
    """The --dcn-impl window audit on the dataset's first sample, with the
    JAX package's words: the net as it is, or with --dcn-window-check
    fallback and taps past the window, the same net rebuilt with the
    gather DCN."""
    from diner_tpu_torch.mvs.net import WINDOW_LIMIT, window_offset_stats

    mode = args.dcn_window_check
    if net.dcn_impl != "window" or mode == "off":
        return net
    max_disp, _ = window_offset_stats(net, *batch_of(ds[0], device))
    limit = WINDOW_LIMIT
    if max_disp >= limit:
        msg = (f"window DCN: max |k + offset| = {max_disp:.3f} >= {limit:.3f}"
               f" on the first batch — out-of-window taps clamp to the window"
               f" edge (approximation; zero offset-gradient there).")
        if mode == "fallback":
            print(f"WARNING: {msg} Falling back to --dcn-impl gather.",
                  flush=True)
            gather = build_net(argparse.Namespace(**{**vars(args),
                                                     "dcn_impl": "gather"}),
                               device)
            gather.load_state_dict(net.state_dict())
            return gather.train(net.training)
        print(f"WARNING: {msg} Use --dcn-impl gather for exact semantics, or "
              f"--dcn-window-check fallback to automate it.", flush=True)
    else:
        print(f"window DCN check: max |k + offset| = {max_disp:.3f} < "
              f"{limit:.3f} — bit-exact vs gather on this batch.", flush=True)
    return net


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


def _write_outputs(net, sample, device):
    out = _run(net, sample, device)
    return (out["depth"][0].cpu().numpy(),
            out["photometric_confidence"][0].cpu().numpy())


def _eval_outputs(net, sample, device):
    out = _run(net, sample, device)
    return out["depth"][0].cpu().numpy(), eval_confidence(out)[0].cpu().numpy()


def local_devices(args, device):
    """The cards --data-parallel spreads samples over: every local CUDA
    device when the flag is given and the run is on CUDA, else `device`."""
    if args.data_parallel and device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def run_samples(net, ds, idxs, fn, devices):
    """Yield (sample, fn(net, sample, device)) for the indices in order.
    With one device, one sample at a time on `net`. With several, one
    sample on each at a time, each device running its own replica of `net`
    in its own thread; the last group is padded with its last sample, as
    the JAX package pads its batch, and the padding's outputs dropped."""
    if len(devices) == 1:
        for i in idxs:
            s = ds[i]
            yield s, fn(net, s, devices[0])
        return
    replicas = [copy.deepcopy(net).to(d) for d in devices]
    B = len(devices)
    with ThreadPoolExecutor(B) as pool:
        for c0 in range(0, len(idxs), B):
            chunk = [ds[i] for i in idxs[c0:c0 + B]]
            padded = chunk + [chunk[-1]] * (B - len(chunk))
            outs = list(pool.map(fn, replicas, padded, devices))
            yield from zip(chunk, outs[:len(chunk)])


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
    net = check_window_dcn(build_net(args, dev), ds, args, dev)
    idxs = process_local_slice(len(ds))
    seconds = []
    t = time.perf_counter()
    for n, (s, (depth, conf)) in enumerate(run_samples(
            net, ds, idxs, _write_outputs, local_devices(args, dev))):
        write_depth_prediction(depth, conf, s["dpath"], scale=args.scale)
        seconds.append(time.perf_counter() - t)
        t = time.perf_counter()
        if n % 20 == 0:
            print(f"wrote {n + 1}/{len(idxs)}", flush=True)
    return seconds


def cmd_train(args, focal: bool = False):
    """Train (or, with focal, finetune) the cascade, across ranks with
    --multihost; returns mvs/train.py's per-step records."""
    import torch.distributed as dist

    from diner_tpu_torch.core.device import resolve_device
    from diner_tpu_torch.parallel import init_multihost, rank, world_size

    dev = resolve_device(args.device)
    if not args.multihost:
        return _train(args, dev, focal)
    own_group = not dist.is_initialized()
    dev = init_multihost(args.coordinator, args.num_processes,
                         args.process_id, device=dev)
    if not dist.is_initialized():
        raise ValueError(
            "--multihost found no process group to join: pass "
            "--coordinator, --num-processes and --process-id, or launch "
            "under torchrun (python -m torch.distributed.run), which sets "
            "MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK")
    print(f"multihost: rank {rank()} of {world_size()} on {dev}", flush=True)
    try:
        return _train(args, dev, focal)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, dev, focal):
    from diner_tpu_torch.mvs.train import train
    from diner_tpu_torch.parallel import world_size

    if focal and args.dataset is None:
        args.dataset = "bld"
    ds = build_mvs_dataset(args, "train")
    net = check_window_dcn(build_net(args, dev), ds, args, dev)
    epochs, factor = args.lrepochs.split(":")
    # steps an epoch at the global batch (--batch-size is each rank's)
    global_batch = args.batch_size * world_size()
    milestones = [int(float(e) * len(ds) / global_batch)
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
    net = check_window_dcn(build_net(args, dev), ds, args, dev)
    out_root = Path(args.outdir)
    idxs = process_local_slice(len(ds))
    seconds = []
    t = time.perf_counter()
    for n, (s, (depth, conf)) in enumerate(run_samples(
            net, ds, idxs, _eval_outputs, local_devices(args, dev))):
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
        t = time.perf_counter()
        if n % 20 == 0:
            print(f"eval wrote {n + 1}/{len(idxs)}", flush=True)
    return seconds


def _read_scan_outputs(scan_dir, pair_path):
    """An eval folder read back: the pair list's (ref, sources) entries
    and, for each view with outputs, its depth, confidence, K, extrinsics
    and image in [0, 1] (None when the PNG is missing)."""
    from diner_tpu_torch.data.codecs import read_mvsnet_cam, read_pfm
    from diner_tpu_torch.image_ops.png import read_png

    pair = Path(pair_path).read_text().splitlines()
    metas = []
    for i in range(int(pair[0])):
        ref = int(pair[1 + 2 * i])
        srcs = [int(x) for x in pair[2 + 2 * i].split()[1::2]]
        if srcs:
            metas.append((ref, srcs))
    data = {}
    for v in sorted({v for r, ss in metas for v in [r] + ss}):
        dp = scan_dir / "depth_est" / f"{v:08d}.pfm"
        if not dp.exists():
            continue
        ext, K, _ = read_mvsnet_cam(scan_dir / "cams" / f"{v:08d}_cam.txt")
        img_p = scan_dir / "images" / f"{v:08d}.png"
        img = (read_png(img_p).astype(np.float32) / 255.0
               if img_p.exists() else None)
        data[v] = {"depth": read_pfm(dp)[0],
                   "conf": read_pfm(scan_dir / "confidence"
                                    / f"{v:08d}.pfm")[0],
                   "K": K, "ext": ext, "img": img}
    return metas, data


def _fuse_normal(metas, data, args, device):
    """The pair-list filter: a reference pixel is kept when its confidence
    exceeds --conf and at least --thres_view of its pair list's sources
    are consistent; its depth averages theirs with its own."""
    from diner_tpu_torch.fusion.consistency import (
        check_geometric_consistency)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    pts_all, col_all = [], []
    for ref, srcs in metas:
        if ref not in data:
            continue
        d = data[ref]
        geo_sum = 0
        dep_sum = 0.0
        for s in srcs:
            if s not in data:
                continue
            mask, dep = check_geometric_consistency(
                t(d["depth"]), t(d["K"]), t(d["ext"]), t(data[s]["depth"]),
                t(data[s]["K"]), t(data[s]["ext"]))
            geo_sum = geo_sum + mask.to(torch.int32)
            dep_sum = dep_sum + dep
        avg = ((dep_sum + t(d["depth"])) / (geo_sum + 1)).cpu().numpy()
        geo = (torch.as_tensor(geo_sum) >= args.thres_view).cpu().numpy()
        m = (d["conf"] > args.conf) & geo
        if not m.any():
            continue
        H, W = d["depth"].shape
        gx, gy = np.meshgrid(np.arange(W), np.arange(H))
        x, y, dd = gx[m], gy[m], avg[m]
        xyz_cam = np.linalg.inv(d["K"]) @ (np.stack([x, y, np.ones_like(x)])
                                           * dd)
        pose = np.linalg.inv(d["ext"])
        xyz_w = (pose[:3, :3] @ xyz_cam + pose[:3, 3:4]).T
        pts_all.append(xyz_w.astype(np.float32))
        img = d["img"]
        col_all.append((img[m] * 255).astype(np.uint8) if img is not None
                       else np.full((m.sum(), 3), 128, np.uint8))
    if not pts_all:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint8)
    return np.concatenate(pts_all), np.concatenate(col_all)


def cmd_fuse(args):
    """Fuse each scan's eval outputs to a PLY. Returns {scan: {"points",
    "seconds", "ply"}}."""
    from diner_tpu_torch.core.device import resolve_device
    from diner_tpu_torch.fusion.consensus import consensus_fusion
    from diner_tpu_torch.fusion.consistency import (depths_to_world_points,
                                                    filter_depths_dynamic)
    from diner_tpu_torch.fusion.ply import write_ply

    dev = resolve_device(args.device)
    out_root = Path(args.outdir)
    results = {}
    for scan in _read_testlist(args.testlist):
        t0 = time.perf_counter()
        metas, data = _read_scan_outputs(
            out_root / scan, Path(args.datapath) / scan / "pair.txt")
        if not data:
            print(f"{scan}: no eval outputs found, skipping")
            continue
        if args.method == "normal":
            pts, cols = _fuse_normal(metas, data, args, dev)
        else:
            views = sorted(data)

            def stack(key):
                return torch.as_tensor(np.stack(
                    [np.asarray(data[v][key], np.float32) for v in views]),
                    device=dev)

            depths, Ks, exts, confs = (stack(k) for k in
                                       ("depth", "K", "ext", "conf"))
            cols_in = torch.as_tensor(np.stack([
                data[v]["img"] if data[v]["img"] is not None
                else np.full((*data[v]["depth"].shape, 3), 0.5, np.float32)
                for v in views]), device=dev)
            if args.method == "dynamic":
                avg, mask = filter_depths_dynamic(depths, Ks, exts, confs,
                                                  conf_thresh=args.conf)
                pts, cols = depths_to_world_points(avg, Ks, exts, cols_in,
                                                   mask)
            else:
                out = consensus_fusion(depths * (confs > args.conf), Ks, exts,
                                       colors=cols_in,
                                       num_consistent=args.num_consistent,
                                       depth_thresh=args.depth_thresh,
                                       depth_mode=args.depth_mode)
                keep = out["keep"]
                pts = out["points"][keep].cpu().numpy()
                cols = out["colors"][keep].cpu().numpy()
        if scan.startswith("scan") and scan[4:].isdigit():
            name = f"mvsnet{int(scan[4:]):03d}_l3.ply"
        else:
            name = f"{scan}.ply"
        ply_path = out_root / name
        write_ply(ply_path, np.asarray(pts), colors=np.asarray(cols))
        results[scan] = {"points": len(pts), "ply": str(ply_path),
                         "seconds": time.perf_counter() - t0}
        print(f"{scan}: fused {len(pts)} points -> {ply_path}")
    return results


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
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="bfloat16: bf16 convs, DCN, FMT and cost volumes "
                        "(geometry, softmax and WTA stay float32)")
    p.add_argument("--dcn-impl", default="gather",
                   choices=["gather", "window"],
                   help="window: the gather-free stencil DCN (exact while "
                        "|offset| < 1 px, the same checkpoints); gather is "
                        "the reference's semantics")
    p.add_argument("--dcn-window-check", default="warn",
                   choices=["warn", "fallback", "off"],
                   help="with --dcn-impl window: audit max |k + offset| on "
                        "the first sample; warn (the default), fall back to "
                        "the gather DCN, or skip")


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
        pt.add_argument("--multihost", action="store_true",
                        help="train data-parallel in a torch.distributed "
                             "process group (reads MASTER_ADDR, MASTER_PORT, "
                             "WORLD_SIZE, RANK and LOCAL_RANK, or the flags "
                             "below); --batch-size is each rank's")
        pt.add_argument("--coordinator", default=None,
                        help="rank 0's HOST:PORT")
        pt.add_argument("--num-processes", type=int, default=None)
        pt.add_argument("--process-id", type=int, default=None)
        _arch_flags(pt)

    pw = sub.add_parser("write", help="write depth priors")
    _data_flags(pw)
    pw.add_argument("--ckpt", default=None,
                    help="a checkpoint directory of `train` (its latest "
                         "step) or one checkpoint file")
    pw.add_argument("--scale", type=float, default=None,
                    help="depth divisor before writing; default 872/0.7 "
                         "for --dataset dtu, 1.0 (metric) for the others")
    pw.add_argument("--data-parallel", action="store_true",
                    help="one sample on each local card at a time")
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
    pe.add_argument("--data-parallel", action="store_true",
                    help="one reference view on each local card at a time")
    _arch_flags(pe)

    pf = sub.add_parser("fuse", help="fuse eval's depth maps to PLY point "
                                     "clouds")
    pf.add_argument("--datapath", required=True,
                    help="the directory holding <scan>/pair.txt")
    pf.add_argument("--testlist", required=True,
                    help="scan-list file or comma-separated scan names")
    pf.add_argument("--outdir", required=True, help="eval's output directory")
    pf.add_argument("--method", default="normal",
                    choices=("normal", "dynamic", "consensus"))
    pf.add_argument("--conf", type=float, default=0.5)
    pf.add_argument("--thres_view", type=int, default=3)
    pf.add_argument("--num_consistent", type=int, default=3)
    pf.add_argument("--depth_thresh", type=float, default=0.01,
                    help="consensus depth agreement: a relative fraction, "
                         "or pixels of disparity in disparity mode")
    pf.add_argument("--depth_mode", default="relative",
                    choices=("relative", "disparity"),
                    help="consensus accept test; disparity is fusibile's "
                         "|f * B * (1/z - 1/d)| < depth_thresh")
    pf.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap


def main(argv=None):
    """Run a subcommand; returns the per-step records of train and
    finetune, the seconds each sample took for write and eval, and fuse's
    per-scan results."""
    args = parser().parse_args(argv)
    if args.cmd == "finetune":
        return cmd_train(args, focal=True)
    return {"train": cmd_train, "write": cmd_write, "eval": cmd_eval,
            "fuse": cmd_fuse}[args.cmd](args)


if __name__ == "__main__":
    main()
