"""PixelNeRF: pixel-aligned conditioned radiance field with depth-aware fusion
(port of diner_tpu.models.pixelnerf).

`encode` builds a SceneEncoding (features + depth/std/normal maps + cameras);
`field` evaluates (rgb, sigma) at world points by projecting them into every
source view, fetching the pixel-aligned features, positional-encoding the
cam-space position and the signed distance to the MVS surface
(depth_dist = ref_depth - point_z), and running the view-conditioned
ResnetFC with a mid-network view mean.

Three render-time variants of the latent fetch cut the rows it gathers; each
needs the sampler's EpiAnchors (RenderConfig.n_prior_anchors > 0 with
anchor_field_depth) and applies only when the field is given them:
`latent_anchors` (index_latent_anchored: the latent at A anchors over each
ray's sample span, lerped per sample), `latent_unique_cells`
(index_latent_unique: each ray's distinct texel cells fetched once) and
`latent_sample_stride` (index_latent_strided: quad rows at every stride-th
sample, exact where a sample shares its anchor's cell). None is certified.

Training: `encode(..., train=True)` runs the encoder's norms in train mode
(BatchNorm on batch statistics, updating its running ones), and
`remat_field=True` recomputes the field MLP's activations in the backward
pass instead of keeping them (torch.utils.checkpoint), as the JAX
package's nn.remat does.

Under a torch.profiler, `encode`, `field_gather` and `field_mlp` are the
spans `model.encode`, `field.gather` (the latent fetch and the MVS depth
lookup; counter `field.samples`) and `field.mlp` (utils.profiling).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from diner_tpu_torch.core.types import (IMAGENET_MEAN, IMAGENET_STD,
                                       EpiAnchors, SceneEncoding)
from diner_tpu_torch.geometry import (depth2normal, project_points,
                                      transform_points)
from diner_tpu_torch.image_ops import (grid_sample, grid_sample_quad,
                                      pack_quad, quad_blend, quad_cells)
from diner_tpu_torch.kernels.remap import remap_anchors
from diner_tpu_torch.nn import ResnetFC, SpatialEncoder, posenc, posenc_dim
from diner_tpu_torch.sampler.depth_guided import anchor_ids
from diner_tpu_torch.utils.profiling import count, span

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _scale_uv_for_feature_padding(enc: SceneEncoding, uv):
    """Shrink uv so that the un-padded image spans the same normalized extent
    inside the latent's replication-padded border."""
    if enc.feature_padding == 0:
        return uv
    hf, wf = enc.latent.shape[2], enc.latent.shape[3]
    size = torch.tensor([wf, hf], dtype=uv.dtype, device=uv.device)
    return uv * (size - 2.0 * enc.feature_padding) / size


def index_latent(enc: SceneEncoding, uv):
    """(SB, NV, N, 2) -> (SB, NV, N, C), bilinear/border. Uses the quad-packed
    latent (one gather) when present; an int8 latent is dequantized after the
    bilinear combine of its integer rows."""
    uv = _scale_uv_for_feature_padding(enc, uv)
    if enc.latent_quad is not None:
        out = grid_sample_quad(enc.latent_quad, uv)
        if enc.latent_scale is not None:
            out = out * enc.latent_scale
        return out
    if enc.latent_scale is not None:
        raise ValueError("latent_quant='int8' requires quad_latent=True")
    return grid_sample(enc.latent, uv, mode="bilinear", padding_mode="border")


def _gather_quad_rows(enc: SceneEncoding, idx):
    """Quad rows of the cells idx (SB, NV, ...) -> (SB, NV, ..., 4C), in
    the latent's own dtype."""
    SB, NV = idx.shape[:2]
    Hq, Wq, C4 = enc.latent_quad.shape[-3:]
    flat = enc.latent_quad.reshape(SB * NV, Hq * Wq, C4)
    rows = flat[torch.arange(SB * NV, device=idx.device)[:, None],
                idx.reshape(SB * NV, -1).long()]
    return rows.reshape(*idx.shape, C4)


def _run_rows(i, n: int):
    """Flat row ids of a (..., M) index into n slots a leading position:
    row (flattened leading position) * n + i, as one int64 vector."""
    lead = i.shape[:-1].numel()
    base = torch.arange(lead, device=i.device)[:, None] * n
    return (base + i.reshape(lead, -1).long()).reshape(-1)


def index_latent_anchored(enc: SceneEncoding, uv, epi_aux: EpiAnchors,
                          n_anchors: int):
    """Epipolar-anchor latent fetch: per (ray, view), the latent at
    `n_anchors` points spanning the samples' segment of the chord, lerped
    per sample. uv (SB, NV, B, 2) ray-major with B = NR * NS. Returns
    (SB, NV, B, C).

    The two anchors around a sample are gathered and lerped with weights
    (1 - w, w) in the fetched latent's dtype, summed in float32: the same
    value as the JAX package's two-hot contraction, whose zeros add 0."""
    if n_anchors < 2:
        raise ValueError("latent_anchors needs >= 2 anchors per chord "
                         "(1 would divide by zero; use 0 for the exact "
                         "bilinear fetch)")
    SB, NV, B, _ = uv.shape
    NR = epi_aux.uv0.shape[2]
    NS = B // NR
    A = n_anchors
    uvr = uv.reshape(SB, NV, NR, NS, 2)

    # the samples' chord coordinate s in [0, 1] (anchor_ids, unrounded)
    t = ((uvr - epi_aux.uv0[..., None, :])
         * epi_aux.duv[..., None, :]).sum(-1)               # (SB, NV, NR, NS)
    dd = epi_aux.dd[..., None]
    s = torch.where(dd > 1e-12, t / torch.where(dd == 0, 1.0, dd),
                    0.5).clamp(0.0, 1.0)
    s_min = s.amin(-1)                                      # (SB, NV, NR)
    span = (s.amax(-1) - s_min).clamp(min=1e-8)
    frac = torch.arange(A, dtype=s.dtype, device=s.device) / (A - 1)
    s_anchor = s_min[..., None] + frac * span[..., None]    # (SB, NV, NR, A)
    uv_anchor = (epi_aux.uv0[..., None, :]
                 + s_anchor[..., None] * epi_aux.duv[..., None, :])
    lat = index_latent(enc, uv_anchor.reshape(SB, NV, NR * A, 2))
    C = lat.shape[-1]
    lat = lat.reshape(SB, NV, NR, A, C)

    x = (s - s_min[..., None]) / span[..., None] * (A - 1)  # (SB, NV, NR, NS)
    i0 = torch.floor(x).to(torch.int32).clamp(0, A - 2)
    w = (x - i0.to(x.dtype)).reshape(SB, NV, B, 1)
    row0 = _run_rows(i0, A)                                 # (SB*NV*NR*NS,)
    lat = lat.reshape(-1, C)
    out = (lat[row0].float() * (1.0 - w).to(lat.dtype).float().reshape(-1, 1)
           + lat[row0 + 1].float() * w.to(lat.dtype).float().reshape(-1, 1))
    return out.to(lat.dtype).reshape(SB, NV, B, C)


def index_latent_strided(enc: SceneEncoding, uv, n_rays: int, stride: int):
    """Strided quad-latent fetch: quad rows at samples 0, L, ..., (P-1)L and
    the last (L = stride, P = NS / L). A sample in its left anchor's texel
    cell gets that row blended with its own in-cell weights (exact), else
    one in its right anchor's cell that row, else the chord-lerp of the two
    anchors' values. uv (SB, NV, B, 2) ray-major, B = n_rays * NS, samples
    z-sorted. Returns (SB, NV, B, C).

    The element-wise work runs in a float latent's own dtype (bf16 at the
    fast preset), as in the JAX package. An int8 latent blends in float32,
    as index_latent does (quad_blend promotes its rows to the weights'
    float32), and is then scaled: the JAX package casts the weights to
    int8 there, which truncates them to 0 or 1."""
    if enc.latent_quad is None:
        raise ValueError("latent_sample_stride requires quad_latent=True")
    SB, NV, B, _ = uv.shape
    NR = n_rays
    NS = B // NR
    L = stride
    if NS % L:
        raise ValueError(f"n_samples={NS} not divisible by "
                         f"latent_sample_stride={L}")
    P = NS // L

    uvs = _scale_uv_for_feature_padding(enc, uv)
    Hq, Wq = enc.latent_quad.shape[-3:-1]
    idx, wx, wy = quad_cells(Hq, Wq, uvs)                   # (SB, NV, B)
    f_pos = torch.tensor([*range(0, P * L, L), NS - 1], device=uv.device)
    idx_s = idx.reshape(SB, NV, NR, NS)
    idx_f = idx_s[..., f_pos]                               # (..., P + 1)
    rows_f = _gather_quad_rows(enc, idx_f)                  # (..., P+1, 4C)
    rows_e, rows_n = rows_f[..., :P, :], rows_f[..., 1:, :]
    idx_e, idx_n = idx_f[..., :P], idx_f[..., 1:]
    idx_r = idx_s.reshape(SB, NV, NR, P, L)
    wdt = (torch.float32 if rows_f.dtype == torch.int8 else rows_f.dtype)
    wx_r = wx.reshape(SB, NV, NR, P, L).to(wdt)
    wy_r = wy.reshape(SB, NV, NR, P, L).to(wdt)

    # the row of the matching anchor (left, else right), blended once
    same_left = idx_r == idx_e[..., None]
    same_right = idx_r == idx_n[..., None]
    rows_sel = torch.where(same_left[..., None], rows_e[..., None, :],
                           rows_n[..., None, :])            # (..., P, L, 4C)
    val_cell = quad_blend(rows_sel, wx_r, wy_r)

    # fallback: the chord-lerp of the anchors' own values
    uvs_f = uvs.reshape(SB, NV, NR, NS, 2)
    uv_anchor = uvs_f[..., f_pos, :]                        # (..., P + 1, 2)
    uv_l, uv_n = uv_anchor[..., :P, :], uv_anchor[..., 1:, :]
    wx_f = wx.reshape(idx_s.shape)[..., f_pos].to(wdt)
    wy_f = wy.reshape(idx_s.shape)[..., f_pos].to(wdt)
    val_anchor = quad_blend(rows_f, wx_f, wy_f)             # (..., P + 1, C)
    duv = uv_n - uv_l
    dd = (duv * duv).sum(-1)[..., None]                     # (..., P, 1)
    uvs_r = uvs_f.reshape(SB, NV, NR, P, L, 2)
    t = ((uvs_r - uv_l[..., None, :]) * duv[..., None, :]).sum(-1)
    t = torch.where(dd > 1e-12, t / dd.clamp(min=1e-12), 0.0).clamp(
        0.0, 1.0).to(wdt)[..., None]                        # (..., P, L, 1)
    val_lerp = (val_anchor[..., :P, None, :] * (1.0 - t)
                + val_anchor[..., 1:, None, :] * t)

    out = torch.where((same_left | same_right)[..., None], val_cell,
                      val_lerp)
    out = out.reshape(SB, NV, B, out.shape[-1])
    if enc.latent_scale is not None:
        out = out * enc.latent_scale
    return out


def index_latent_unique(enc: SceneEncoding, uv, n_rays: int, n_cells: int):
    """Run-length quad-latent fetch: each (ray, view)'s first K = n_cells
    distinct texel cells (runs of z-sorted samples) are fetched once, and
    each sample takes its run's row by its run id, with its own in-cell
    weights: exact for every sample whose run id < K; a later sample reuses
    run K-1's row. uv (SB, NV, B, 2) ray-major, B = n_rays * NS. Returns
    (SB, NV, B, C).

    The JAX package selects the rows with a one-hot contraction (0/1
    weights, float32 sums; int8 values are exact in its bf16): a gather on
    the run id gives the same values."""
    if enc.latent_quad is None:
        raise ValueError("latent_unique_cells requires quad_latent=True")
    SB, NV, B, _ = uv.shape
    NR = n_rays
    NS = B // NR
    K = n_cells

    uvs = _scale_uv_for_feature_padding(enc, uv)
    Hq, Wq = enc.latent_quad.shape[-3:-1]
    idx, wx, wy = quad_cells(Hq, Wq, uvs)                   # (SB, NV, B)
    idx_s = idx.reshape(SB, NV, NR, NS)

    # run id: the count of cell changes before a sample, capped at K - 1
    g = torch.cumsum((idx_s[..., 1:] != idx_s[..., :-1]).to(torch.int32),
                     -1)
    g = torch.cat([torch.zeros_like(g[..., :1]), g], -1)
    gk = g.clamp(max=K - 1).long()
    # run -> cell: the max over the run's samples (one cell each; the
    # overflow run K-1 mixes cells; an empty run gives cell 0)
    cells = torch.zeros((SB, NV, NR, K), dtype=idx_s.dtype,
                        device=idx_s.device).scatter_reduce(
                            -1, gk, idx_s, "amax")
    rows_k = _gather_quad_rows(enc, cells)                  # (..., K, 4C)
    rows = rows_k.reshape(-1, rows_k.shape[-1])[_run_rows(gk, K)]
    out = quad_blend(rows.reshape(SB, NV, B, -1), wx, wy)
    if enc.latent_scale is not None:
        out = out * enc.latent_scale
    return out


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
                 latent_unique_cells: int = 0):
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
        with span("model.encode"):
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

            focal = torch.stack([intrinsics[..., 0, 0],
                                 intrinsics[..., 1, 1]], -1)
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
        with span("field.gather"):
            SB, B, _ = xyz.shape
            count("field.samples", SB * B)
            NV = enc.poses.shape[1]
            xyz_cam = transform_points(enc.poses,
                                       xyz[:, None].expand(SB, NV, B, 3))
            uv = project_points(xyz_cam, enc.focal, enc.c, enc.image_shape)
            if self.latent_anchors and epi_aux is not None:
                latent = index_latent_anchored(enc, uv, epi_aux,
                                               self.latent_anchors)
            elif self.latent_unique_cells and epi_aux is not None:
                latent = index_latent_unique(enc, uv, epi_aux.uv0.shape[2],
                                             self.latent_unique_cells)
            elif self.latent_sample_stride > 1 and epi_aux is not None:
                latent = index_latent_strided(enc, uv, epi_aux.uv0.shape[2],
                                              self.latent_sample_stride)
            else:
                latent = index_latent(enc, uv)
            if epi_aux is not None:
                ref_depth = _anchor_ref_depth(epi_aux, uv)
            else:
                ref_depth = index_depth(enc, uv)[..., 0]
            return {"latent": latent, "ref_depth": ref_depth}

    def field_mlp(self, enc: SceneEncoding, gathered, xyz, viewdirs):
        """Positional features + conditioned MLP + heads -> (SB, B, 4)."""
        with span("field.mlp"):
            SB, B, _ = xyz.shape
            NV = enc.poses.shape[1]
            xyz_cam = transform_points(enc.poses,
                                       xyz[:, None].expand(SB, NV, B, 3))
            z_feature = posenc(xyz_cam, self.num_freqs, self.freq_factor)
            rot = enc.poses[..., :3, :3]
            dirs_cam = (viewdirs[:, None].expand(SB, NV, B, 3)
                        @ rot.transpose(-1, -2))
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
