"""Models from a configuration's sections (frozen copy of the port's
cli/build.py, without the dataset registry)."""

from __future__ import annotations

from typing import Any, Dict

from reference.core.types import RenderConfig
from reference.models.diner import DINER
from reference.models.pixelnerf import PixelNeRF


def nerf_kwargs(conf: Dict[str, Any]) -> Dict[str, Any]:
    """PixelNeRF's constructor arguments from a `nerf` section."""
    nerf_kw = dict(conf.get("kwargs", {}))
    enc_kw = dict(nerf_kw.pop("encoder_conf", {}).get("kwargs", {}))
    pos_kw = dict(nerf_kw.pop("poscode_conf", {}).get("kwargs", {}))
    mlp_kw = dict(nerf_kw.pop("mlp_fine_conf", {}).get("kwargs", {}))
    return dict(
        num_freqs=int(pos_kw.get("num_freqs", 6)),
        freq_factor=float(pos_kw.get("freq_factor", 6.28)),
        backbone=enc_kw.get("backbone", "resnet34"),
        encoder_layers=int(enc_kw.get("num_layers", 4)),
        encoder_norm=enc_kw.get("norm", "group"),
        image_padding=int(enc_kw.get("image_padding", 64)),
        padding_pe=int(enc_kw.get("padding_pe", 4)),
        n_blocks=int(mlp_kw.get("n_blocks", 5)),
        d_hidden=int(mlp_kw.get("d_hidden", 512)),
        combine_layer=int(mlp_kw.get("combine_layer", 3)),
        **nerf_kw)


def build_nerf(conf: Dict[str, Any], **overrides) -> PixelNeRF:
    """A PixelNeRF from a `nerf` section; `overrides` replace its
    arguments."""
    return PixelNeRF(**{**nerf_kwargs(conf), **overrides})


def build_render_cfg(conf: Dict[str, Any]) -> RenderConfig:
    """A RenderConfig from a `renderer` section."""
    kw = dict(conf.get("kwargs", {}))
    n_samples = int(kw.get("n_samples", 40))
    # the reference's eval_batch_size counts points (nerf_renderer.py:28);
    # render tiles are in rays, and either knob is accepted
    if "eval_chunk_rays" in kw:
        eval_chunk_rays = int(kw["eval_chunk_rays"])
    elif "eval_batch_size" in kw:
        eval_chunk_rays = max(1, int(kw["eval_batch_size"]) // n_samples)
    else:
        eval_chunk_rays = 8192
    return RenderConfig(
        n_samples=n_samples,
        n_depth_candidates=int(kw.get("n_depth_candidates", 1000)),
        n_gaussian=int(kw.get("n_gaussian", 15)),
        depth_diff_max=float(kw.get("depth_diff_max", 0.05)),
        white_bkgd=bool(kw.get("white_bkgd", False)),
        eval_chunk_rays=eval_chunk_rays,
        approx_topk=bool(kw.get("approx_topk", True)),
        prior_stride=int(kw.get("prior_stride", 1)),
        n_prior_anchors=int(kw.get("n_prior_anchors", 0)),
        anchor_field_depth=bool(kw.get("anchor_field_depth", True)),
        paired_prior_gather=bool(kw.get("paired_prior_gather", False)),
        likelihood=str(kw.get("likelihood", "v1")))


def build_diner(conf: Dict[str, Any], znear: float, zfar: float,
                **nerf_overrides) -> DINER:
    """DINER from a whole config: nerf, renderer and the optimizer
    section's loss settings."""
    opt_kw = dict(conf.get("optimizer", {}).get("kwargs", {}))
    return DINER(nerf=build_nerf(conf["nerf"], **nerf_overrides),
                 render_cfg=build_render_cfg(conf.get("renderer", {})),
                 znear=float(znear), zfar=float(zfar),
                 ray_batch_size=int(opt_kw.get("ray_batch_size", 128)),
                 w_vgg=float(opt_kw.get("w_vgg", 0.0)),
                 vgg_spatch=int(opt_kw.get("vgg_spatch", 64)),
                 w_antibias=float(opt_kw.get("w_antibias", 0.0)),
                 antibias_downsampling=int(opt_kw.get(
                     "antibias_downsampling", 3)),
                 erode_fg_mask=int(opt_kw.get("erode_fg_mask", 0)))


def optimizer_kwargs(conf: Dict[str, Any]) -> Dict[str, Any]:
    """create_train_state's arguments from the optimizer section: lr and
    the schedule."""
    opt_kw = dict(conf.get("optimizer", {}).get("kwargs", {}))
    out = {"lr": float(opt_kw.get("lr", 1e-4))}
    out.update({k: opt_kw[k] for k in
                ("lr_schedule", "lr_decay_steps", "lr_warmup_steps")
                if k in opt_kw})
    return out
