"""Build models and datasets from reference-shaped YAML configs (port of
diner_tpu.cli.build).

A config has `data`, `nerf`, `renderer` and `optimizer` sections with
module + kwargs wiring: datasets resolve against the registry, models
through typed constructors; the optimizer section gives the loss weights and
patch settings. Registered datasets: DTUDataset (alias DTUDataSet),
FacescapeDataset (alias FacescapeDataSet), MultiFaceDataset and
SyntheticSphereDataset.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict

from diner_tpu_torch.core.config import build as registry_build
from diner_tpu_torch.core.config import register, resolve
from diner_tpu_torch.core.types import RenderConfig
from diner_tpu_torch.data.dtu import DTUDataset
from diner_tpu_torch.data.facescape import FacescapeDataset
from diner_tpu_torch.data.loader import BatchLoader
from diner_tpu_torch.data.multiface import MultiFaceDataset
from diner_tpu_torch.data.synthetic import SyntheticSphereDataset
from diner_tpu_torch.models.diner import DINER
from diner_tpu_torch.models.pixelnerf import PixelNeRF

# the second names of DTU and FaceScape are the reference's class names
for _name, _cls in (("DTUDataset", DTUDataset), ("DTUDataSet", DTUDataset),
                    ("FacescapeDataset", FacescapeDataset),
                    ("FacescapeDataSet", FacescapeDataset),
                    ("MultiFaceDataset", MultiFaceDataset),
                    ("SyntheticSphereDataset", SyntheticSphereDataset)):
    register(_name)(_cls)


def build_dataset(conf: Dict[str, Any], stage: str):
    """The dataset of one `data` split; `stage` goes to constructors that
    take it."""
    dconf = conf["dataset"]
    cls = resolve(dconf["module"])
    params = inspect.signature(cls.__init__ if isinstance(cls, type)
                               else cls).parameters
    if "stage" in params:
        return registry_build(dconf, stage=stage)
    return registry_build(dconf)


def build_loader(conf: Dict[str, Any], dataset,
                 shuffle_default: bool) -> BatchLoader:
    """The BatchLoader of one `data` split's `dataloader` section. Its
    shuffle seed is the loader's default, 0, whatever the run's seed, as
    the JAX package's build_loader has it."""
    kw = dict(conf.get("dataloader", {}).get("kwargs", {}))
    return BatchLoader(dataset, batch_size=int(kw.get("batch_size", 1)),
                       shuffle=bool(kw.get("shuffle", shuffle_default)),
                       num_threads=int(kw.get("num_workers", 4)))


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
