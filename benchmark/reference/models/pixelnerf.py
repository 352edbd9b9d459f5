"""PixelNeRF: pixel-aligned conditioned radiance field with depth-aware fusion
(port of diner_tpu.models.pixelnerf).

`encode` builds a SceneEncoding (features + depth/std/normal maps + cameras);
`field` evaluates (rgb, sigma) at world points by projecting them into every
source view, fetching the pixel-aligned features, positional-encoding the
cam-space position and the signed distance to the MVS surface
(depth_dist = ref_depth - point_z), and running the view-conditioned
ResnetFC with a mid-network view mean.

The reference keeps the exact latent fetch alone: the port's latent-fetch
variants (anchors, unique cells, a stride) are in no cell.

Training: `encode(..., train=True)` runs the encoder's norms in train mode
(BatchNorm on batch statistics, updating its running ones), and
`remat_field=True` recomputes the field MLP's activations in the backward
pass instead of keeping them (torch.utils.checkpoint), as the JAX
package's nn.remat does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.core.types import (IMAGENET_MEAN, IMAGENET_STD,
                                       EpiAnchors, SceneEncoding)
from reference.geometry import (depth2normal, project_points,
                                      transform_points)
from reference.image_ops import grid_sample, grid_sample_quad, pack_quad
from reference.kernels.remap import remap_anchors
from reference.nn import ResnetFC, SpatialEncoder, posenc, posenc_dim
from reference.sampler.depth_guided import anchor_ids

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16,
           "float8_e4m3fn": torch.float8_e4m3fn}


def _scale_uv_for_feature_padding(enc: SceneEncoding, uv):
    """Shrink uv so that the un-padded image spans the same normalized extent
    inside the latent's replication-padded border."""
    if enc.feature_padding == 0:
        return uv
    hf, wf = enc.latent.shape[2], enc.latent.shape[3]
    size = torch.tensor([wf, hf], dtype=uv.dtype, device=uv.device)
    return uv * (size - 2.0 * enc.feature_padding) / size


def index_latent(enc: SceneEncoding, uv, blend_dtype=None):
    """(SB, NV, N, 2) -> (SB, NV, N, C), bilinear/border. Uses the quad-packed
    latent (one gather) when present; an int8 latent is dequantized after the
    bilinear combine of its integer rows. blend_dtype (a control's) blends
    the quad rows and applies the int8 scale in that type instead of
    float32."""
    uv = _scale_uv_for_feature_padding(enc, uv)
    if enc.latent_quad is not None:
        out = grid_sample_quad(enc.latent_quad, uv, blend_dtype)
        if enc.latent_scale is not None:
            out = out * enc.latent_scale.to(out.dtype)
        return out
    if enc.latent_scale is not None:
        raise ValueError("latent_quant='int8' requires quad_latent=True")
    return grid_sample(enc.latent, uv, mode="bilinear", padding_mode="border")


def index_depth(enc: SceneEncoding, uv):
    return grid_sample(enc.depths, uv, mode="nearest", padding_mode="border")


def index_depth_std(enc: SceneEncoding, uv):
    """The depth std, nearest; outside the image it doubles every 12 px
    and is 0 beyond 100 px (image_encoder.py:186-195 of the reference)."""
    return grid_sample(enc.depth_stds, uv, mode="nearest",
                       padding_mode="exponential", pad_double_width=12.0,
                       pad_size=100)


def index_normal(enc: SceneEncoding, uv):
    return grid_sample(enc.normals, uv, mode="nearest", padding_mode="zeros")


def _anchor_ref_depth(epi_aux: EpiAnchors, uv):
    """Per-sample MVS depth from the sampler's anchor table.

    uv (SB, NV, B, 2) with B = NR * NS ordered ray-major. Each sample maps to
    its nearest anchor on the chord by arithmetic, and kernel K2 selects the
    anchor depth exactly. Returns (SB, NV, B) f32.
    """
    SB, NV, NR, A = epi_aux.depth.shape
    B = uv.shape[2]
    NS = B // NR
    a = anchor_ids(uv.reshape(SB, NV, NR, NS, 2), epi_aux.uv0, epi_aux.duv,
                   epi_aux.dd, A)
    G = SB * NV * NR
    out = remap_anchors(a.reshape(G, NS),
                        epi_aux.depth.reshape(G, 1, A).float().contiguous())
    return out.reshape(SB, NV, B)


class PixelNeRF(nn.Module):
    """Encoder + field. Arguments as diner_tpu.models.PixelNeRF's fields."""

    def __init__(self, num_freqs: int = 6, freq_factor: float = 6.28,
                 backbone: str = "resnet34", encoder_layers: int = 4,
                 encoder_norm: str = "group", image_padding: int = 64,
                 padding_pe: int = 4, n_blocks: int = 5, d_hidden: int = 512,
                 combine_layer: int = 3, compute_dtype: str = "float32",
                 quad_latent: bool = False, latent_quant: str = "none",
                 sigma_bias_init: float = 0.5,
                 sigma_activation: str = "softplus",
                 remat_field: bool = False, latent_anchors: int = 0,
                 latent_sample_stride: int = 0,
                 latent_unique_cells: int = 0,
                 blend_dtype: str = "float32"):
        super().__init__()
        if compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
        if latent_quant not in ("none", "int8"):
            raise ValueError(f"unknown latent_quant {latent_quant!r}")
        if latent_quant == "int8" and not quad_latent:
            raise ValueError("latent_quant='int8' requires quad_latent=True")
        if sigma_activation not in ("softplus", "relu"):
            raise ValueError(f"unknown sigma_activation {sigma_activation!r}")
        self.num_freqs, self.freq_factor = num_freqs, freq_factor
        self.quad_latent, self.latent_quant = quad_latent, latent_quant
        self.sigma_activation = sigma_activation
        self.remat_field = remat_field
        self.latent_anchors = latent_anchors
        self.latent_sample_stride = latent_sample_stride
        self.latent_unique_cells = latent_unique_cells
        self.dtype = _DTYPES[compute_dtype]
        self.blend_dtype = _DTYPES[blend_dtype]
        self.encoder = SpatialEncoder(
            backbone=backbone, num_layers=encoder_layers, norm=encoder_norm,
            image_padding=image_padding, padding_pe=padding_pe,
            dtype=self.dtype)
        d_in = posenc_dim(3, num_freqs) + posenc_dim(1, num_freqs) + 3
        self.mlp = ResnetFC(d_in=d_in, d_out=4, n_blocks=n_blocks,
                            d_latent=self.encoder.latent_size,
                            d_hidden=d_hidden, combine_layer=combine_layer,
                            dtype=self.dtype,
                            out_bias_init=(0.0, 0.0, 0.0, sigma_bias_init),
                            zero_init_out_channels=(3,))

    def encode(self, images, depths, depth_stds, extrinsics, intrinsics,
               train: bool = False) -> SceneEncoding:
        """images (SB, NV, H, W, 3) in [0, 1]; depths/stds (SB, NV, H, W, 1);
        extrinsics (SB, NV, 4, 4); intrinsics (SB, NV, 3, 3). train puts the
        encoder in train mode, else in eval mode."""
        self.encoder.train(train)
        SB, NV, H, W, _ = images.shape
        mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype,
                            device=images.device)
        std = torch.tensor(IMAGENET_STD, dtype=images.dtype,
                           device=images.device)
        x = (images - mean) / std

        normals = depth2normal(depths.reshape(SB * NV, H, W, 1),
                               intrinsics.reshape(SB * NV, 3, 3))
        normals = normals.reshape(SB, NV, H, W, 3)

        latent = self.encoder(x.reshape(SB * NV, H, W, 3))
        latent = latent.reshape(SB, NV, *latent.shape[1:])
        latent_scale = None
        if self.latent_quant == "int8":
            scale = latent.abs().amax(dim=(0, 1, 2, 3)) / 127.0
            scale = scale.clamp(min=1e-12)
            latent = torch.round(latent / scale).clamp(-127, 127).to(
                torch.int8)
            latent_scale = scale.float()
        elif self.dtype is not None:
            latent = latent.to(self.dtype)

        focal = torch.stack([intrinsics[..., 0, 0], intrinsics[..., 1, 1]],
                            -1)
        return SceneEncoding(
            latent=latent, depths=depths, depth_stds=depth_stds,
            normals=normals, poses=extrinsics, focal=focal,
            c=intrinsics[..., :2, 2],
            latent_quad=pack_quad(latent) if self.quad_latent else None,
            latent_scale=latent_scale,
            feature_padding=self.encoder.feature_padding)

    def field_gather(self, enc: SceneEncoding, xyz,
                     epi_aux: Optional[EpiAnchors] = None):
        """Project xyz (SB, B, 3) into every view and fetch the latent rows
        and the per-sample MVS depth. Returns dict(latent (SB, NV, B, C),
        ref_depth (SB, NV, B)). With epi_aux, a latent-fetch variant applies
        if one is set (anchors, then unique cells, then a stride > 1)."""
        SB, B, _ = xyz.shape
        NV = enc.poses.shape[1]
        xyz_cam = transform_points(enc.poses, xyz[:, None].expand(SB, NV, B,
                                                                  3))
        uv = project_points(xyz_cam, enc.focal, enc.c, enc.image_shape)
        if self.latent_anchors or self.latent_unique_cells \
                or self.latent_sample_stride > 1:
            raise ValueError("the reference has no latent-fetch variant")
        latent = index_latent(enc, uv, self.blend_dtype)
        if epi_aux is not None:
            ref_depth = _anchor_ref_depth(epi_aux, uv)
        else:
            ref_depth = index_depth(enc, uv)[..., 0]
        return {"latent": latent, "ref_depth": ref_depth}

    def field_mlp(self, enc: SceneEncoding, gathered, xyz, viewdirs):
        """Positional features + conditioned MLP + heads -> (SB, B, 4)."""
        SB, B, _ = xyz.shape
        NV = enc.poses.shape[1]
        xyz_cam = transform_points(enc.poses, xyz[:, None].expand(SB, NV, B,
                                                                  3))
        z_feature = posenc(xyz_cam, self.num_freqs, self.freq_factor)
        rot = enc.poses[..., :3, :3]
        dirs_cam = viewdirs[:, None].expand(SB, NV, B, 3) @ rot.transpose(
            -1, -2)
        depth_dist = gathered["ref_depth"] - xyz_cam[..., 2]
        depth_feature = posenc(depth_dist[..., None], self.num_freqs,
                               self.freq_factor)
        mlp_in = torch.cat([gathered["latent"], z_feature, dirs_cam,
                            depth_feature], dim=-1)
        if self.remat_field and torch.is_grad_enabled():
            out = checkpoint(self.mlp, mlp_in, 1, use_reentrant=False)
        else:
            out = self.mlp(mlp_in, 1)                      # (SB, B, 4)
        rgb = torch.sigmoid(out[..., :3])
        if self.sigma_activation == "softplus":
            sigma = F.softplus(out[..., 3:4])
        else:
            sigma = F.relu(out[..., 3:4])
        return torch.cat([rgb, sigma], dim=-1)

    def field(self, enc: SceneEncoding, xyz, viewdirs,
              epi_aux: Optional[EpiAnchors] = None):
        """xyz, viewdirs (SB, B, 3) world space -> (SB, B, 4) [rgb, sigma].
        With epi_aux, xyz must be ordered ray-major like the anchors."""
        return self.field_mlp(enc, self.field_gather(enc, xyz, epi_aux), xyz,
                              viewdirs)
