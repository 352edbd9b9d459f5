"""Render-server sessions: the generator and the check of traffic whose
`kind` is "sessions".

A closed loop of one client. A session loads the next scene of
a pool made from the seed (`RenderServer.load_scene`), renders
`frames_per_session` frames along a camera sweep around it, each with its
own seed (`RenderServer.render`, every frame copied back to the host as a
client receives it), and unloads it. The frames that the window rendered
are checked after it against the plain reference, which encodes each
sampled frame's scene again and renders the frame from the same inputs,
weights and noise seed."""

from __future__ import annotations

import time

import numpy as np
import torch

from lib import common, scenes, weights

SCENE_KEYS = ("src_rgbs", "src_depths", "src_depth_stds", "src_extrinsics",
              "src_intrinsics")


class Sessions:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 fault=None):
        self.phases = common.Phases()
        from diner_tpu_torch.cli.build import build_nerf, build_render_cfg
        from diner_tpu_torch.serve import RenderServer

        self.phases.mark("import")
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.H, self.W = config["image_hw"]
        serve = config["serve"]
        model = common.on_device(lambda: build_nerf(serve["nerf"]), seed,
                                 self.device)
        self.layout = weights.layout(model)
        cfg = build_render_cfg(serve["renderer"])
        self.server = RenderServer(model, cfg, scenes.ZNEAR, scenes.ZFAR,
                                   buckets=((self.H, self.W),),
                                   chunk=cfg.eval_chunk_rays,
                                   device=self.device)
        if fault is not None:
            fault(self.server)
        self.phases.mark("model")
        self.pool = scenes.scene_pool(
            weights.sub_seed(seed, "scenes"), traffic["pool_scenes"],
            config["n_views"], self.H, self.W, config["depth_std"])
        self.sweep = scenes.cam_sweep(traffic["frames_per_session"],
                                      traffic["sweep_radius"],
                                      traffic["sweep_height"])
        self.frame_seed0 = weights.sub_seed(seed, "frames") % 2 ** 62
        self.clock = common.Clock(self.device)
        self.frames: list = []
        self.loads = 0
        self.phases.mark("scenes")
        # warm-up: the cell's shapes, once (cuDNN and cuBLAS selection,
        # the kernels' first launches)
        for _ in range(traffic["warmup_sessions"]):
            self._load("warmup", self.pool[0])
            self._render("warmup", self.sweep[0], 0)
            self.server.unload_scene("warmup")
        common.sync(self.device)
        self.phases.mark("warmup")

    # -- the traffic -------------------------------------------------------
    def _load(self, sid, scene):
        self.server.load_scene(sid, *(scene[k] for k in SCENE_KEYS))

    def _render(self, sid, ext, frame_seed):
        rgb, depth = self.server.render(sid, ext[None],
                                        self.pool[0]["K"][None], self.H,
                                        self.W, seed=frame_seed)
        return rgb.cpu(), depth.cpu()

    def window(self, seconds: float) -> float:
        """Run sessions until `seconds` have passed; the frame under way
        then completes. Returns the window's seconds."""
        n_pool, per = len(self.pool), self.traffic["frames_per_session"]
        t0 = time.perf_counter()
        session = 0
        while True:
            sid = f"s{session}"
            scene_idx = session % n_pool
            with torch.profiler.record_function("bench.load_scene"):
                self.clock.timed("load_scene", self._load, sid,
                                 self.pool[scene_idx])
            self.loads += 1
            done = False
            for j in range(per):
                fseed = self.frame_seed0 + len(self.frames)
                with torch.profiler.record_function("bench.render"):
                    rgb, depth = self._render(sid, self.sweep[j], fseed)
                self.frames.append((scene_idx, j, fseed, rgb, depth))
                if time.perf_counter() - t0 >= seconds:
                    done = True
                    break
            self.server.unload_scene(sid)
            session += 1
            if done:
                return time.perf_counter() - t0

    def end_to_end(self, window_s: float, peak_bytes: int) -> dict:
        rays = len(self.frames) * self.H * self.W
        return {"render_rays_per_s": rays / window_s}

    def counts(self) -> dict:
        return {"frames": len(self.frames), "loads": self.loads,
                "rays": len(self.frames) * self.H * self.W,
                "samples": (len(self.frames) * self.H * self.W
                            * self.server.cfg.n_samples)}

    @property
    def attempted(self) -> int:
        return len(self.frames)

    def release(self):
        """Free the program's state before the reference runs."""
        self.server = None
        common.free_device(self.device)

    # -- the check ---------------------------------------------------------
    def sample(self) -> list:
        """The frames to check: `check_frames` of the window's, drawn from
        the seed."""
        rng = np.random.RandomState(weights.sub_seed(self.seed, "sample")
                                    % 2 ** 31)
        n = min(self.traffic["check_frames"], len(self.frames))
        return sorted(rng.choice(len(self.frames), n, replace=False))

    def reference_frames(self, picks, precision: dict):
        """The reference's render of each picked frame, in `precision`: a
        compute_dtype and the TF32 flags, and a control's blend_dtype and
        render_dtype for the parts that the configuration states in
        float32 (the quad latent's blend; the sampler's depths and the
        compositing)."""
        from reference import config as rconfig
        from reference.geometry import gen_rays
        from reference.renderer import render_image

        serve = self.config["serve"]
        model = common.on_device(lambda: rconfig.build_nerf(
            serve["nerf"], compute_dtype=precision["compute_dtype"],
            blend_dtype=precision.get("blend_dtype", "float32")),
            self.seed, self.device)
        render_dtype = precision.get("render_dtype")
        if render_dtype is not None:
            render_dtype = getattr(torch, render_dtype)
        if weights.layout(model) != self.layout:
            raise RuntimeError("the reference's parameters differ from the "
                               "program's")
        model.eval()
        cfg = rconfig.build_render_cfg(serve["renderer"])
        out = []
        dev = self.device
        with common.Precision(precision["matmul_tf32"],
                              precision["cudnn_tf32"]), \
                torch.inference_mode():
            for i in picks:
                scene_idx, j, fseed = self.frames[i][:3]
                scene = self.pool[scene_idx]
                enc = model.encode(*(torch.as_tensor(
                    scene[k], dtype=torch.float32, device=dev)
                    for k in SCENE_KEYS))
                rays = gen_rays(
                    torch.as_tensor(self.sweep[j][None], device=dev),
                    torch.as_tensor(scene["K"][None], device=dev),
                    self.W, self.H,
                    torch.full((1,), scenes.ZNEAR, device=dev),
                    torch.full((1,), scenes.ZFAR, device=dev))
                rgb, depth = render_image(
                    lambda p, d, aux: model.field(enc, p, d, aux), rays, enc,
                    cfg, chunk=cfg.eval_chunk_rays, seed=fseed, device=dev,
                    render_dtype=render_dtype)
                out.append((rgb.cpu(), depth.cpu()))
        del model
        common.free_device(dev)
        return out

    def gaps(self, ref, stated, got=None) -> dict:
        """The numbers compared, each the worst over the picked frames.
        `ref` is the float32 reference, `stated` the reference in the
        configuration's stated precision (`reference_stated`), and a
        frame's own rounding is the mean |stated - ref|.
        rgb_err_ratio: a frame's mean |rgb - ref rgb| over its own
        rounding: how many times the stated precision's rounding the frame
        is off from float32. rgb_stated_gap: the mean |rgb - stated rgb|
        over the same rounding: how far the frame departs from the stated
        precision, which a rounding of its own in a lower precision moves
        far more than it moves the first. depth_err_ratio and
        depth_stated_gap: the same for depth. rgb_mae and depth_mae (the
        latter over the depth range) are the mean |frame - ref|. `got`
        replaces the program's frames (a control)."""
        got = got or [self.frames[i][3:5] for i in self.picks]
        span = scenes.ZFAR - scenes.ZNEAR
        out = dict.fromkeys(("rgb_err_ratio", "depth_err_ratio",
                             "rgb_stated_gap", "depth_stated_gap",
                             "rgb_mae", "depth_mae"), 0.0)
        for (rgb, depth), (r_rgb, r_depth), (s_rgb, s_depth) in zip(
                got, ref, stated):
            if not (torch.isfinite(rgb).all() and torch.isfinite(depth).all()):
                return {k: float("inf") for k in out}
            e_rgb = (rgb - r_rgb).abs().mean().item()
            e_depth = (depth - r_depth).abs().mean().item() / span
            g_rgb = (rgb - s_rgb).abs().mean().item()
            g_depth = (depth - s_depth).abs().mean().item() / span
            s_rgb = max((s_rgb - r_rgb).abs().mean().item(), 1e-12)
            s_depth = max((s_depth - r_depth).abs().mean().item() / span,
                          1e-12)
            for k, v in (("rgb_err_ratio", e_rgb / s_rgb),
                         ("depth_err_ratio", e_depth / s_depth),
                         ("rgb_stated_gap", g_rgb / s_rgb),
                         ("depth_stated_gap", g_depth / s_depth),
                         ("rgb_mae", e_rgb), ("depth_mae", e_depth)):
                out[k] = max(out[k], v)
        return out

    def check(self) -> dict:
        self.picks = self.sample()
        self.ref = self.reference_frames(self.picks, self.config["reference"])
        self.stated = self.reference_frames(
            self.picks, self.config["reference_stated"])
        return self.gaps(self.ref, self.stated)

    def control_check(self) -> dict:
        """{control: the numbers compared}, each control the reference in a
        precision of the configuration's `controls` put in the program's
        place (after check())."""
        return {name: self.gaps(self.ref, self.stated,
                                self.reference_frames(self.picks, prec))
                for name, prec in self.config["controls"].items()}

GENERATOR = Sessions
