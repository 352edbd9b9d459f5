"""Scene-cache render server: encode once, render many (port of
diner_tpu.serve.RenderServer).

- `RenderServer.from_preset(config_path, ...)` builds a server from a YAML
  render preset, e.g. configs/evaluate_diner_on_dtu_fast.yaml.
- `load_scene(...)` runs the encoder once and keeps the SceneEncoding on the
  device (quad-packed / int8-quantized per the model's settings).
- `render(scene_id, extrinsics, intrinsics, H, W)` renders novel views with
  the depth-guided renderer; every request must match one of the server's
  (H, W) buckets.
- Requests may come from any thread: a lock keeps the scene table
  consistent.
"""

from __future__ import annotations

import threading
from typing import Dict, Mapping, Optional, Tuple

import torch

from diner_tpu_torch.core.device import resolve_device
from diner_tpu_torch.core.types import RenderConfig, SceneEncoding
from diner_tpu_torch.geometry import gen_rays
from diner_tpu_torch.models.pixelnerf import PixelNeRF
from diner_tpu_torch.renderer import render_image


class RenderServer:
    """Holds encoded scenes and renders requests against them.

    model: a PixelNeRF with its weights; it is moved to `device` (CUDA
    unless the caller asks for "cpu") and put in eval mode.
    """

    @classmethod
    def from_preset(cls, config_path, state_dict: Optional[Mapping],
                    znear: float, zfar: float, **kw) -> "RenderServer":
        """A server for the model and renderer of a YAML preset (its `nerf`
        and `renderer` sections). state_dict: the PixelNeRF weights, which
        must match the preset's model; None keeps the model's initial
        weights, drawn from torch's global generator. `kw` goes to the
        constructor (buckets, chunk, device); chunk defaults to the preset's
        eval_chunk_rays."""
        from diner_tpu_torch.cli.build import build_nerf, build_render_cfg
        from diner_tpu_torch.core.config import load_config

        conf = load_config(config_path)
        model = build_nerf(conf.get("nerf", {}))
        if state_dict is not None:
            model.load_state_dict(state_dict)
        cfg = build_render_cfg(conf.get("renderer", {}))
        kw.setdefault("chunk", cfg.eval_chunk_rays)
        return cls(model, cfg, znear, zfar, **kw)

    def __init__(self, model: PixelNeRF, cfg: RenderConfig, znear: float,
                 zfar: float,
                 buckets: Tuple[Tuple[int, int], ...] = ((256, 320),),
                 chunk: int = 8192, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.znear, self.zfar = float(znear), float(zfar)
        self.buckets = tuple(tuple(b) for b in buckets)
        self.chunk = chunk
        self._scenes: Dict[str, SceneEncoding] = {}
        self._lock = threading.Lock()

    def _tensor(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # -- scene management ---------------------------------------------------
    @torch.inference_mode()
    def load_scene(self, scene_id: str, src_rgbs, src_depths, src_depth_stds,
                   src_extrinsics, src_intrinsics) -> None:
        """Encode the source views (SB, NV, ...) once and keep the encoding
        on the device."""
        enc = self.model.encode(*(self._tensor(x) for x in (
            src_rgbs, src_depths, src_depth_stds, src_extrinsics,
            src_intrinsics)))
        with self._lock:
            self._scenes[scene_id] = enc

    def unload_scene(self, scene_id: str) -> bool:
        with self._lock:
            return self._scenes.pop(scene_id, None) is not None

    def scene_ids(self):
        with self._lock:
            return sorted(self._scenes)

    # -- rendering ----------------------------------------------------------
    @torch.inference_mode()
    def render(self, scene_id: str, target_extrinsics, target_intrinsics,
               H: int, W: int, seed: int = 0):
        """-> (rgb (SB, H, W, 3) in [0, 1], depth (SB, H, W)), float32 on the
        server's device."""
        if (H, W) not in self.buckets:
            raise ValueError(f"size {(H, W)} not in buckets {self.buckets}")
        with self._lock:
            enc = self._scenes.get(scene_id)
        if enc is None:
            raise ValueError(
                f"unknown scene {scene_id!r}; loaded: {self.scene_ids()}")
        ext = self._tensor(target_extrinsics)
        SB = ext.shape[0]
        rays = gen_rays(ext, self._tensor(target_intrinsics), W, H,
                        torch.full((SB,), self.znear, device=self.device),
                        torch.full((SB,), self.zfar, device=self.device))
        return render_image(
            lambda p, d, aux: self.model.field(enc, p, d, aux), rays, enc,
            self.cfg, chunk=self.chunk, seed=seed, device=self.device)
