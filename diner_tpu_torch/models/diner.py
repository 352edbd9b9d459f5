"""DINER: PixelNeRF + the depth-guided renderer (port of the render half of
diner_tpu.models.diner; the training losses are not ported yet).

render_batch(batch): encode the source views once, then render the full
target images in ray chunks.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from diner_tpu_torch.core.device import resolve_device
from diner_tpu_torch.core.types import RenderConfig
from diner_tpu_torch.geometry import gen_rays
from diner_tpu_torch.models.pixelnerf import PixelNeRF
from diner_tpu_torch.renderer import render_image

SOURCE_KEYS = ("src_rgbs", "src_depths", "src_depth_stds", "src_extrinsics",
               "src_intrinsics")


def to_tensors(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The array entries of a sample batch as float32 tensors on device."""
    return {k: torch.as_tensor(v).to(device=device, dtype=torch.float32)
            for k, v in batch.items()
            if isinstance(v, (np.ndarray, torch.Tensor))}


class DINER(nn.Module):
    def __init__(self, nerf: PixelNeRF,
                 render_cfg: RenderConfig = RenderConfig(),
                 znear: float = 0.5, zfar: float = 2.5):
        super().__init__()
        self.nerf = nerf
        self.render_cfg = render_cfg
        self.znear, self.zfar = znear, zfar

    def encode_batch(self, batch):
        return self.nerf.encode(*(batch[k] for k in SOURCE_KEYS))

    def render_batch(self, batch: Dict, chunk: Optional[int] = None,
                     target_extrinsics=None, noise=None, seed: int = 0,
                     device="cuda"):
        """Full-image prediction on `device` (CUDA unless the caller asks for
        "cpu"). batch: sample dict of numpy arrays or tensors, batched
        (leading SB axis). Returns (rgb (SB, H, W, 3), depth (SB, H, W)).
        noise: optional per-chunk noise tuples (see render_image)."""
        dev = resolve_device(device)
        self.to(dev).eval()  # outside inference mode: params stay trainable
        if chunk is None:
            chunk = self.render_cfg.eval_chunk_rays
        with torch.inference_mode():
            batch = to_tensors(batch, dev)
            SB, H, W, _ = batch["target_rgb"].shape
            enc = self.encode_batch(batch)
            ext = (batch["target_extrinsics"] if target_extrinsics is None
                   else torch.as_tensor(target_extrinsics, device=dev))
            rays = gen_rays(ext, batch["target_intrinsics"], W, H,
                            torch.full((SB,), self.znear, device=dev),
                            torch.full((SB,), self.zfar, device=dev))
            return render_image(
                lambda p, d, aux: self.nerf.field(enc, p, d, aux), rays, enc,
                self.render_cfg, chunk=chunk, noise=noise, seed=seed,
                device=dev)
