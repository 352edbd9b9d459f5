"""Bulk eval: render a prediction folder from a checkpoint and score it (port
of diner_tpu.cli.render_eval).

    python -m diner_tpu_torch.cli.render_eval --config CONFIG.yaml \
        --torch-ckpt MODEL.ckpt --out OUTDIR [--n N] [--nsamples K] \
        [--device cuda|cpu]

The checkpoint is a reference Lightning .ckpt (models/lightning.py maps it).
The reference stack is BatchNorm + relu sigma (image_encoder.py:58,
nerf_renderer.py:311), so those are forced whatever the YAML says, and the
checkpoint's conv1 must take the 3 + border-PE channels the config implies.
As in the reference (create_prediction_folder.py), --n renders a
deterministic Random(0) subset of the config's `data.val` set, --nsamples
overrides n_samples and scales n_gaussian with it, and znear/zfar come from
the dataset. Writes OUTDIR/visualizations/*.png and the score reports in
OUTDIR; prints the seconds per image and the mean scores.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

REFERENCE_ARCH = {"encoder_norm": "batch", "sigma_activation": "relu"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--torch-ckpt", required=True,
                    help="reference Lightning .ckpt, mapped on load")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=None, help="eval subset size")
    ap.add_argument("--nsamples", type=int, default=None,
                    help="override renderer n_samples (scales n_gaussian)")
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

    dev = resolve_device(args.device)
    conf = load_config(args.config)
    val_set = build_dataset(conf["data"]["val"], stage="val")
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
            f"channels but the config implies {expect_in} (3 + border-PE); "
            f"set padding_pe/image_padding to match the training run")
    if forced:
        print(f"--torch-ckpt forces {forced}")
    model = build_diner(conf, znear=val_set.znear, zfar=val_set.zfar,
                        **forced)
    if args.nsamples:
        cfg = model.render_cfg
        scale = args.nsamples / cfg.n_samples
        model.render_cfg = dataclasses.replace(
            cfg, n_samples=args.nsamples,
            n_gaussian=int(cfg.n_gaussian * scale))
    model.nerf.load_state_dict(sd)
    print(f"loaded reference checkpoint {args.torch_ckpt} (znear="
          f"{extras['znear']}, zfar={extras['zfar']})")

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
    scores = evaluate_folder(visdir, out)
    print({k: round(v, 4) for k, v in scores.items()})
    return scores


if __name__ == "__main__":
    main()
