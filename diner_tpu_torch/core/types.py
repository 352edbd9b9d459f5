"""Core data types: the scene encoding, the render hyperparameters and the
sampler's epipolar-anchor state.

Field for field the counterparts of `diner_tpu.core.types` and
`diner_tpu.sampler.depth_guided.EpiAnchors`. All maps stay NHWC so that the
port's arrays compare directly with the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

LIKELIHOOD_ROUTES = ("v1", "chord")


@dataclasses.dataclass
class SceneEncoding:
    """Everything render-time code needs about the source views.

    All maps NHWC. SB = scene batch, NV = source views.
    """

    latent: torch.Tensor       # (SB, NV, Hf, Wf, C) pixel-aligned features
    depths: torch.Tensor       # (SB, NV, H, W, 1) metric depth, 0 = invalid
    depth_stds: torch.Tensor   # (SB, NV, H, W, 1) per-pixel depth sigma
    normals: torch.Tensor      # (SB, NV, H, W, 3) cam-space normals
    poses: torch.Tensor        # (SB, NV, 4, 4) world->cam extrinsics
    focal: torch.Tensor        # (SB, NV, 2) [fx, fy]
    c: torch.Tensor            # (SB, NV, 2) [cx, cy]
    # optional quad-packed latent (pack_quad): one-gather bilinear fetch
    latent_quad: Optional[torch.Tensor] = None
    # per-channel dequantization scale of an int8 latent: feature = q * scale
    latent_scale: Optional[torch.Tensor] = None
    feature_padding: int = 0

    @property
    def image_shape(self):
        """(W, H) of the source images."""
        return (self.depths.shape[3], self.depths.shape[2])


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static renderer hyperparameters (same fields and defaults as
    `diner_tpu.core.types.RenderConfig`; see there for each one's rationale).

    `approx_topk` is kept for config compatibility: the port always runs an
    exact `torch.topk`, which is what `jax.lax.approx_max_k` computes off the
    TPU.

    `likelihood` picks the anchor branch's likelihood route: "v1" (kernel K1
    on the ids and cam depths computed in PyTorch) or "chord" (kernel K3,
    which computes them from the chord scalars itself). It is the port's
    explicit counterpart of the JAX package's DINER_TPU_LIKELIHOOD switch,
    with the same values and default.
    """

    n_samples: int = 40
    n_depth_candidates: int = 1000
    n_gaussian: int = 15
    depth_diff_max: float = 0.05
    white_bkgd: bool = False
    eval_chunk_rays: int = 8192
    approx_topk: bool = True
    prior_stride: int = 1
    n_prior_anchors: int = 0
    anchor_field_depth: bool = True
    paired_prior_gather: bool = False
    likelihood: str = "v1"

    def __post_init__(self):
        if self.likelihood not in LIKELIHOOD_ROUTES:
            raise ValueError(f"likelihood must be one of {LIKELIHOOD_ROUTES}, "
                             f"got {self.likelihood!r}")


@dataclasses.dataclass
class EpiAnchors:
    """Per-(view, ray) epipolar-anchor state of the sampler, reused by the
    field for its per-sample MVS depth lookup."""

    uv0: torch.Tensor    # (SB, NV, NR, 2) chord start (first candidate's uv)
    duv: torch.Tensor    # (SB, NV, NR, 2) chord vector (last - first)
    dd: torch.Tensor     # (SB, NV, NR) squared chord length
    depth: torch.Tensor  # (SB, NV, NR, A) anchor depth values
