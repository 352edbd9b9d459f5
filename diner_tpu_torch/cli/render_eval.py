"""Bulk eval: render a prediction folder from a checkpoint and score it (port
of diner_tpu.cli.render_eval).

    python -m diner_tpu_torch.cli.render_eval --config CONFIG.yaml \
        (--ckpt RUN/ckpts | --torch-ckpt MODEL.ckpt) --out OUTDIR [--n N] \
        [--nsamples K] [--shard-rays] [--lpips WEIGHTS.npz] \
        [--device cuda|cpu]

--ckpt takes a checkpoint the port's trainer wrote (a ckpts directory,
whose latest step is used, or one step_*.pt file); the model is the
config's as it stands. --torch-ckpt takes a reference Lightning .ckpt
(models/lightning.py maps it). The reference stack is BatchNorm + relu
sigma (image_encoder.py:58, nerf_renderer.py:311), so those are forced
whatever the YAML says, and the checkpoint's conv1 must take the 3 +
border-PE channels the config implies.
As in the reference (create_prediction_folder.py), --n renders a
deterministic Random(0) subset of the config's `data.val` set, --nsamples
overrides n_samples and scales n_gaussian with it, and znear/zfar come from
the dataset. Writes OUTDIR/visualizations/*.png and the score reports in
OUTDIR; prints the seconds per image and the mean scores. --lpips adds the
LPIPS score (weights from scripts/port_lpips.py; see nn/lpips.py), on the
same device as the renders. --shard-rays splits each image's rays over
every visible card (renderer/sharded.py: one model replica a card, a host
thread each) when the device is cuda and more than one card is visible;
otherwise it prints that it renders unsharded on one device and renders as
without the flag.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import torch

REFERENCE_ARCH = {"encoder_norm": "batch", "sigma_activation": "relu"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--ckpt", help="a checkpoint of the port's trainer: "
                       "its ckpts directory (latest step) or a step file")
    which.add_argument("--torch-ckpt",
                       help="reference Lightning .ckpt, mapped on load")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=None, help="eval subset size")
    ap.add_argument("--nsamples", type=int, default=None,
                    help="override renderer n_samples (scales n_gaussian)")
    ap.add_argument("--shard-rays", action="store_true",
                    help="shard the ray axis over all devices (multi-chip)")
    ap.add_argument("--lpips", default=None,
                    help="LPIPS-VGG weights (.npz; scripts/port_lpips.py): "
                         "adds lpips to the scores")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from diner_tpu_torch.cli.build import (build_dataset, build_diner,
                                           nerf_kwargs)
    from diner_tpu_torch.core.config import load_config
    from diner_tpu_torch.core.device import resolve_device
    from diner_tpu_torch.eval.predict import (create_prediction_folder,
                                              deterministic_subset)
    from diner_tpu_torch.eval.suite import evaluate_folder
    from diner_tpu_torch.models.lightning import (from_lightning,
                                                  load_torch_state_dict)
    from diner_tpu_torch.nn import posenc_dim
    from diner_tpu_torch.train.ckpt_io import restore_latest

    dev = resolve_device(args.device)
    conf = load_config(args.config)
    val_set = build_dataset(conf["data"]["val"], stage="val")
    if args.ckpt:
        payload, step = restore_latest(args.ckpt)
        if payload is None:
            raise SystemExit(f"no checkpoint under {args.ckpt}")
        model = build_diner(conf, znear=val_set.znear, zfar=val_set.zfar)
        model.nerf.load_state_dict(payload["nerf"])
        loaded = f"checkpoint {args.ckpt} at step {step}"
    else:
        kw = nerf_kwargs(conf["nerf"])
        sd, extras = from_lightning(load_torch_state_dict(args.torch_ckpt),
                                    kw["backbone"], kw["encoder_layers"])
        forced = {k: v for k, v in REFERENCE_ARCH.items()
                  if kw.get(k) != v}
        expect_in = 3
        if kw["image_padding"] > 0 and kw["padding_pe"] >= 0:
            expect_in += posenc_dim(2, kw["padding_pe"], include_input=True)
        if extras["conv1_in_channels"] != expect_in:
            raise SystemExit(
                f"checkpoint conv1 has {extras['conv1_in_channels']} input "
                f"channels but the config implies {expect_in} (3 + "
                f"border-PE); set padding_pe/image_padding to match the "
                f"training run")
        if forced:
            print(f"--torch-ckpt forces {forced}")
        model = build_diner(conf, znear=val_set.znear, zfar=val_set.zfar,
                            **forced)
        model.nerf.load_state_dict(sd)
        loaded = (f"reference checkpoint {args.torch_ckpt} (znear="
                  f"{extras['znear']}, zfar={extras['zfar']})")
    if args.nsamples:
        cfg = model.render_cfg
        scale = args.nsamples / cfg.n_samples
        model.render_cfg = dataclasses.replace(
            cfg, n_samples=args.nsamples,
            n_gaussian=int(cfg.n_gaussian * scale))
    print(f"loaded {loaded}")

    render_fn = None
    if args.shard_rays:
        n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        if n_cards > 1:
            render_fn = _sharded_render_fn(
                model, [torch.device("cuda", i) for i in range(n_cards)])
            print(f"--shard-rays: rendering each image's rays over "
                  f"{n_cards} cards")
        else:
            print(f"--shard-rays: {max(n_cards, 1)} {dev.type} device "
                  f"visible; rendering unsharded on one device ({dev})")
    if render_fn is None:
        def render_fn(batch, seed):
            rgb, depth = model.render_batch(batch, seed=seed, device=dev)
            return rgb.cpu().numpy(), depth.cpu().numpy()

    out = Path(args.out)
    n_images = len(deterministic_subset(len(val_set), args.n))
    t = time.perf_counter()
    visdir = create_prediction_folder(render_fn, val_set,
                                      out / "visualizations",
                                      n_samples=args.n)
    seconds = time.perf_counter() - t
    print(f"rendered {n_images} images on {dev} in {seconds:.3f} s: "
          f"{seconds / n_images:.4f} s per image (PNG writing included)")
    lpips_fn = None
    if args.lpips:
        from diner_tpu_torch.nn.lpips import load_lpips_npz, make_lpips_fn

        lpips_fn = make_lpips_fn(load_lpips_npz(args.lpips), dev)
    scores = evaluate_folder(visdir, out, lpips_fn=lpips_fn)
    print({k: round(v, 4) for k, v in scores.items()})
    return scores


def _sharded_render_fn(model, devices):
    """render_fn with each image's rays sharded over `devices`: the source
    views are encoded on devices[0], and the field evaluates on the replica
    of its points' device."""
    import copy

    from diner_tpu_torch.geometry import gen_rays
    from diner_tpu_torch.models.diner import to_tensors
    from diner_tpu_torch.renderer.sharded import render_image_sharded

    model.to(devices[0]).eval()
    replicas = {devices[0]: model.nerf}
    for d in devices[1:]:
        if d not in replicas:
            replicas[d] = copy.deepcopy(model.nerf).to(d).eval()

    def field(enc, p, d, aux=None):
        return replicas[p.device].field(enc, p, d, aux)

    def render_fn(batch, seed):
        with torch.inference_mode():
            b = to_tensors(batch, devices[0])
            SB, H, W, _ = b["target_rgb"].shape
            enc = model.encode_batch(b)
            rays = gen_rays(b["target_extrinsics"], b["target_intrinsics"],
                            W, H, torch.full((SB,), model.znear,
                                             device=devices[0]),
                            torch.full((SB,), model.zfar,
                                       device=devices[0]))
            rgb, depth = render_image_sharded(
                field, rays, enc, model.render_cfg, devices,
                chunk=model.render_cfg.eval_chunk_rays, seed=seed)
        return rgb.cpu().numpy(), depth.cpu().numpy()

    return render_fn


if __name__ == "__main__":
    main()
