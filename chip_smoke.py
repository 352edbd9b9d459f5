#!/usr/bin/env python3
"""Build diner_tpu_torch's CUDA kernels and drive the port on one GPU.

Run from the repo root on a machine with a CUDA card and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits nonzero before the
last line:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. nvcc builds every kernel under diner_tpu_torch/csrc/, in parallel;
  3. K1 (likelihood_from_anchors) at the fast preset's chunk shapes vs its
     plain PyTorch version on the card: bitwise selection, p within 2e-6;
     kernel, plain and bound times;
  4. K2 (remap_anchors) likewise: bitwise;
  5. serving at full width: a RenderServer with the fast DTU render preset's
     model (ResNet34 + batch norm, ResnetFC 512x5, bf16, int8 quad latent,
     A=256 paired anchors, 1000 candidates -> 32 samples, 4096-ray chunks),
     random weights from a seed, a synthetic 4-view 256x320 scene, 3
     requests at 256x320. Each request must launch K1 and K2 20 times each;
  6. quality: the trained fixture tests/fixtures/fastpath_tiny.npz, loaded
     with from_jax, renders its held-out scene on the card on the exact f32
     and the fast paths (TF32 off), over 16 noise draws: mean exact
     PSNR-vs-GT > 20 dB, |mean fast - mean exact| <= 0.1 dB, and each path's
     first render agrees with the same render on the CPU;
  7. one JSON line {"kernels": [...]} with every kernel's launches on the
     main path (phase 5), error and times;
  8. the last line {"ok": true, "device": {...}}.
Exits nonzero, printing no result, when no CUDA device is present.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
# operations of K1 per candidate: gates (5), scale and the two erf
# arguments (8), two erff (~20 each), the bin mass (3)
K1_OPS_PER_CANDIDATE = 56

H, W, NV = 256, 320, 4   # presets.FAST_DTU_IMAGE, FAST_DTU_VIEWS
N_REQUESTS = 3
# one render's fast - exact PSNR delta moves by ~0.1 dB with the noise draw
# alone (measured on the CPU over 12 draws: -0.16 .. +0.04 dB, mean
# -0.06 dB), so the gate holds the mean over several draws
QUALITY_SEEDS = 16
G, NC, A, NS = 1 * NV * 4096, 1000, 256, 32   # one chunk of the preset


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


def time_ms(fn, flush, iters=30, warmup=3):
    """Median CUDA-event time of fn over `iters` runs, L2 flushed before
    each."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes, n_ops=0):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_card():
    import torch

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    card = out.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()}")
    return card


def phase_build():
    from diner_tpu_torch.kernels import build_all
    from diner_tpu_torch.kernels.build import kernel_sources

    t = time.perf_counter()
    build_all()
    log(f"build: nvcc {kernel_sources()} in {time.perf_counter() - t:.2f} s")


def phase_k1(flush):
    import torch

    from diner_tpu_torch.kernels import (likelihood_from_anchors,
                                         likelihood_from_anchors_plain)

    gen = torch.Generator(device="cuda").manual_seed(1)
    dev = torch.device("cuda")
    depth = torch.rand(G, A, generator=gen, device=dev) * 2.0 + 1.0
    std = torch.rand(G, A, generator=gen, device=dev) * 0.3
    std[torch.rand(G, A, generator=gen, device=dev) < 0.2] = 0.0
    cos = torch.rand(G, A, generator=gen, device=dev) - 0.7
    vals = torch.stack([depth, std, cos], dim=1).contiguous()
    a = torch.randint(0, A, (G, NC), generator=gen, device=dev)
    a = torch.sort(a, dim=-1).values.to(torch.int32)
    # candidates near their anchor's depth, so both sides of every gate occur
    z = (torch.gather(depth, 1, a.long())
         + (torch.rand(G, NC, generator=gen, device=dev) - 0.5) * 0.12)
    hs = torch.rand(G, 1, generator=gen, device=dev) * 0.01 + 0.001
    ddm = 0.05

    p, sel = likelihood_from_anchors(a, vals, z, hs, ddm,
                                     return_selected=True)
    p_ref, sel_ref = likelihood_from_anchors_plain(a, vals, z, hs, ddm,
                                                   return_selected=True)
    torch.cuda.synchronize()
    check(torch.equal(sel, sel_ref), "K1 selection differs from the plain "
                                     "version's")
    err = (p - p_ref).abs().max().item()
    gate = ((p > 0) == (p_ref > 0)).float().mean().item()
    log(f"K1 likelihood_from_anchors G={G} NC={NC} A={A}: selection "
        f"bitwise equal; p max abs diff {err:.3e} (<= 2e-6: erff vs "
        f"torch.erf ulps); nonzero-p agreement {gate:.6f}; "
        f"{(p > 0).float().mean().item():.3f} of candidates pass the gates")
    check(err <= 2e-6, f"K1 p differs by {err}")

    ms = time_ms(lambda: likelihood_from_anchors(a, vals, z, hs, ddm), flush)
    plain_ms = time_ms(lambda: likelihood_from_anchors_plain(
        a, vals, z, hs, ddm), flush)
    n_bytes = 4 * (3 * G * NC + 3 * G * A + G)
    bound_ms, bound_by = bound(n_bytes, K1_OPS_PER_CANDIDATE * G * NC)
    log(f"K1 time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB)")
    return dict(name="likelihood_from_anchors", route="cuda",
                source="diner_tpu_torch/csrc/likelihood.cu",
                replaces="diner_tpu/sampler/pallas_likelihood.py:102",
                max_abs_err=err, ms=ms, kernel_ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def phase_k2(flush):
    import torch

    from diner_tpu_torch.kernels import remap_anchors, remap_anchors_plain

    gen = torch.Generator(device="cuda").manual_seed(2)
    dev = torch.device("cuda")
    vals = torch.rand(G, 1, A, generator=gen, device=dev) * 2.0 + 1.0
    a = torch.randint(0, A, (G, NS), generator=gen, device=dev)
    a = torch.sort(a, dim=-1).values.to(torch.int32)
    out = remap_anchors(a, vals)
    ref = remap_anchors_plain(a, vals)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), "K2 differs from the plain version")
    err = (out - ref).abs().max().item()
    log(f"K2 remap_anchors G={G} NS={NS} A={A}: bitwise equal")

    idx = a.long()[:, None, :]
    ms = time_ms(lambda: remap_anchors(a, vals), flush)
    plain_ms = time_ms(lambda: remap_anchors_plain(a, vals), flush)
    library_ms = time_ms(lambda: torch.gather(vals, 2, idx), flush)
    n_bytes = 4 * (G * NS + G * A + G * NS)
    bound_ms, bound_by = bound(n_bytes)
    log(f"K2 time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.gather {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {n_bytes / 1e6:.1f} MB)")
    return dict(name="remap_anchors", route="cuda",
                source="diner_tpu_torch/csrc/remap.cu",
                replaces="diner_tpu/sampler/pallas_remap.py:48",
                max_abs_err=err, ms=ms, kernel_ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def phase_serve(card):
    import torch

    from diner_tpu_torch.core import RenderConfig
    from diner_tpu_torch.data import SyntheticSphereDataset
    from diner_tpu_torch.kernels import KERNELS
    from diner_tpu_torch.models import PixelNeRF
    from diner_tpu_torch.presets import FAST_DTU_MODEL, FAST_DTU_RENDER
    from diner_tpu_torch.serve import RenderServer

    torch.manual_seed(0)
    model = PixelNeRF(**FAST_DTU_MODEL)
    cfg = RenderConfig(**FAST_DTU_RENDER)
    ds = SyntheticSphereDataset(n_scenes=1, n_views=NV, H=H, W=W, seed=0)
    s = ds[0]
    server = RenderServer(model, cfg, znear=ds.znear, zfar=ds.zfar,
                          buckets=((H, W),), chunk=cfg.eval_chunk_rays)
    chunks = -(-H * W // cfg.eval_chunk_rays)

    for k in KERNELS.values():
        k.launches = 0
    t = time.perf_counter()
    server.load_scene("scene0", *(s[k][None] for k in (
        "src_rgbs", "src_depths", "src_depth_stds", "src_extrinsics",
        "src_intrinsics")))
    torch.cuda.synchronize()
    log(f"serve: load_scene (encode 4 x {H}x{W}) "
        f"{time.perf_counter() - t:.3f} s")
    counts = {n: [k.launches] for n, k in KERNELS.items()}
    seconds = []
    for i in range(N_REQUESTS):
        t = time.perf_counter()
        rgb, depth = server.render("scene0", s["target_extrinsics"][None],
                                   s["target_intrinsics"][None], H, W,
                                   seed=i)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        for n, k in KERNELS.items():
            counts[n].append(k.launches)
        check(tuple(rgb.shape) == (1, H, W, 3), f"rgb shape {rgb.shape}")
        check(bool(torch.isfinite(rgb).all()), "rgb not finite")
        check(rgb.min().item() >= 0.0 and rgb.max().item() <= 1.0,
              "rgb outside [0, 1]")
        check(bool(torch.isfinite(depth).all()), "depth not finite")
        log(f"serve: request {i} {seconds[-1]:.4f} s, "
            f"{H * W / seconds[-1]:.1f} rays/s [{card}]")
    launches = {n: c[-1] for n, c in counts.items()}
    for n, c in counts.items():
        steps = [b - a for a, b in zip(c, c[1:])]
        check(c[0] == 0 and steps == [chunks] * N_REQUESTS,
              f"{n} launches per request {steps}, expected {chunks} each")
    med = statistics.median(seconds[1:])
    log(f"serve: {N_REQUESTS} requests at {H}x{W}, launches per request "
        f"{ {n: chunks for n in counts} }; steady request {med:.4f} s = "
        f"{H * W / med:.1f} rays/s [{card}]")
    return launches


def _fixture():
    import numpy as np

    data = np.load(ROOT / "tests" / "fixtures" / "fastpath_tiny.npz")
    meta = json.loads(str(data["__meta__"]))
    params = {}
    for key in data.files:
        if key == "__meta__":
            continue
        node = params
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key].astype(np.float32)
    return params, meta


def phase_quality():
    import numpy as np
    import torch

    from diner_tpu_torch.core import RenderConfig
    from diner_tpu_torch.data import SyntheticSphereDataset, collate
    from diner_tpu_torch.models import DINER, PixelNeRF, from_jax

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("quality: TF32 off for convolutions and matmuls in this phase")
    params, meta = _fixture()
    sd = from_jax(params)
    h, w = 128, 160   # the held-out scene of test_fastpath_regression.py
    batch = collate([SyntheticSphereDataset(
        n_scenes=1, n_views=meta["data_kw"]["n_views"], H=h, W=w,
        seed=777)[0]])
    gt = batch["target_rgb"]
    fast = dict(compute_dtype="bfloat16", quad_latent=True,
                latent_quant="int8")
    paths = {"exact_f32": ({}, dict(n_prior_anchors=0)),
             "fast": (fast, dict(n_prior_anchors=96))}

    def psnr(x, y):
        return float(-10.0 * np.log10(np.mean((x - y) ** 2)))

    result = {}
    for name, (mkw, rkw) in paths.items():
        cfg = RenderConfig(**dict(meta["render_kw"], **rkw))
        model = DINER(PixelNeRF(**dict(meta["model_kw"], **mkw)), cfg,
                      znear=meta["znear"], zfar=meta["zfar"])
        model.load_state_dict(sd)
        result[name] = []
        for seed in range(QUALITY_SEEDS):
            gen = torch.Generator().manual_seed(seed)
            chunk = cfg.eval_chunk_rays
            noise = [(torch.rand(1, chunk, cfg.n_depth_candidates,
                                 generator=gen),
                      torch.randn(1, chunk, cfg.n_gaussian, generator=gen),
                      torch.rand(1, chunk, cfg.n_samples, generator=gen))
                     for _ in range(-(-h * w // chunk))]
            out, _ = model.render_batch(batch, noise=noise, device="cuda")
            rgb = np.clip(out.cpu().numpy(), 0.0, 1.0)
            result[name].append(psnr(rgb, gt))
            if seed == 0:  # the same render on the CPU's plain versions
                out, _ = model.render_batch(batch, noise=noise, device="cpu")
                agree = psnr(rgb, np.clip(out.numpy(), 0.0, 1.0))
                log(f"quality: {name} card vs CPU {agree:.2f} dB")
                check(agree >= (40.0 if name == "exact_f32" else 30.0),
                      f"{name}: card and CPU renders disagree")
        log(f"quality: {name} PSNR-vs-GT per seed "
            f"{[round(p, 4) for p in result[name]]} dB on the card")
    mean = {n: statistics.fmean(p) for n, p in result.items()}
    delta = mean["fast"] - mean["exact_f32"]
    log(f"quality: mean PSNR-vs-GT exact {mean['exact_f32']:.4f} dB, fast "
        f"{mean['fast']:.4f} dB, fast - exact {delta:+.4f} dB (gate 0.1 dB)")
    check(mean["exact_f32"] > 20.0, "fixture renders garbage")
    check(abs(delta) <= 0.1, f"fast path off by {delta:+.4f} dB")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import diner_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: diner_tpu_torch not found next to this script "
              f"({e})", file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    try:
        card = phase_card()
        phase_build()
        flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
        kernels = [phase_k1(flush), phase_k2(flush)]
        del flush
        launches = phase_serve(card)
        for k in kernels:
            k["launches"] = launches[k["name"]]
        phase_quality()
    except Exception:  # every phase failure ends the run without a result
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t0:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                for kern in kernels]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
