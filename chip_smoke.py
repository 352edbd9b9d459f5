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
  4. K2 (remap_anchors) likewise: bitwise, also at ragged shapes (NS 7, 32
     and 45; C 1 and 5; K 6 and 256; a partial last block of 256 threads);
     kernel, plain, torch.gather and bound times;
  5. K3 (likelihood_from_chord) at the same chunk: bitwise anchor ids,
     p within 2e-6, the share of gated-off (view, candidate) pairs (the
     kernel's time depends on it); also at ragged shapes (NC 997, NV 1
     and 3, SB 2, A 8 and 1,024) with std and cos at the gates' edges
     (NaN p where the plain version's is NaN); times;
  6. K4 (composite_rays) at 4096 rays x 32 samples in the field's float32:
     rgb, depth and acc within 1e-5 + 1e-5 |plain| (the kernel's shuffle
     scan and warp sums take the products and sums in another order); times;
  7. serving at full width: RenderServer.from_preset(configs/
     evaluate_diner_on_dtu_fast.yaml) (ResNet34 + batch norm, ResnetFC
     512x5, bf16, int8 quad latent, A=256 paired anchors, 1000 candidates
     -> 32 samples, 4096-ray chunks), random weights from a seed, a
     synthetic 4-view 256x320 scene. 3 requests on the default "v1"
     likelihood route must launch K1, K2 and K4 20 times each and K3 never;
     then 2 requests on the "chord" route must launch K3, K2 and K4 20 times
     each and K1 never;
  8. the FaceScape fast preset (group norm, white background) serves 2
     requests at 256x256: K1, K2 and K4 16 times each;
  9. quality: the trained fixture tests/fixtures/fastpath_tiny.npz, loaded
     with from_jax, renders its held-out scene on the card on the exact f32,
     the fast and the fast chord-route paths (TF32 off), over 16 noise
     draws: mean exact PSNR-vs-GT > 20 dB, |mean fast - mean exact| <= 0.1
     dB on each fast path, and each path's first render agrees with the
     same render on the CPU;
  10. bulk eval: the random fast-DTU model goes through to_lightning and
     torch.save, and cli/render_eval renders and scores two synthetic 4-view
     256x320 scenes from that checkpoint: 8 PNGs, finite scores;
  11. one JSON line {"kernels": [...]} with every kernel's launches on its
     route (phase 7), error and times;
  12. the last line {"ok": true, "device": {...}}.
Exits nonzero, printing no result, when no CUDA device is present.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DTU_PRESET = ROOT / "configs" / "evaluate_diner_on_dtu_fast.yaml"
FACESCAPE_PRESET = ROOT / "configs" / "evaluate_diner_on_facescape_fast.yaml"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
SPIN_CYCLES = 2_000_000       # about 1 ms at the H100's 1.98 GHz
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
# operations of K1 per candidate: gates (5), scale and the two erf
# arguments (8), two erff (~20 each), the bin mass (3)
K1_OPS_PER_CANDIDATE = 56
# K3 per (view, candidate): K1's 56 and the chord arithmetic and anchor id
# (10); the two erff (40 of them) only where the gates pass
K3_OPS_PER_CANDIDATE = 66
K3_OPS_ERF = 40
# K4 per sample: delta, alpha with one expf (~12), the scan step, the
# weight, and four multiply-adds
K4_OPS_PER_SAMPLE = 25

H, W, NV = 256, 320, 4   # the DTU evaluation image and its source views
FACESCAPE_HW = (256, 256)
N_REQUESTS = 3           # on the v1 route; the chord route and FaceScape: 2
# one render's fast - exact PSNR delta moves by ~0.1 dB with the noise draw
# alone (measured on the CPU over 12 draws: -0.16 .. +0.04 dB, mean
# -0.06 dB), so the gate holds the mean over several draws
QUALITY_SEEDS = 16
NR = 4096                # rays per chunk of the preset
G, NC, A, NS = 1 * NV * NR, 1000, 256, 32   # one chunk of the preset


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


def time_ms(fn, flush, iters=30, warmup=3):
    """Median CUDA-event time of fn over `iters` runs, L2 flushed before
    each. A spin of about 1 ms between the flush and the start event keeps
    the card busy while the host enqueues fn's launches, so that the events
    time device work and not the host's launch gaps."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
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
    from diner_tpu_torch.kernels.remap import launch_geometry

    def inputs(seed, g, c, ns, k):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        vals = torch.rand(g, c, k, generator=gen, device="cuda") * 2.0 + 1.0
        a = torch.randint(0, k, (g, ns), generator=gen, device="cuda")
        return torch.sort(a, dim=-1).values.to(torch.int32), vals

    a, vals = inputs(2, G, 1, NS, A)
    out = remap_anchors(a, vals)
    ref = remap_anchors_plain(a, vals)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), "K2 differs from the plain version")
    err = (out - ref).abs().max().item()
    log(f"K2 remap_anchors G={G} NS={NS} A={A}: bitwise equal")
    # ragged shapes: NS below, at and above a warp, C > 1, K not a multiple
    # of 4, outputs that do not fill the last block's threads
    shapes = [(1001, c, ns, k) for ns in (7, 32, 45) for c in (1, 5)
              for k in (6, 256)]
    for i, (g, c, ns, k) in enumerate(shapes):
        check(g * c * ns % launch_geometry(g, c, ns)[1] != 0,
              "the outputs fill the last block")
        ra, rv = inputs(20 + i, g, c, ns, k)
        check(torch.equal(remap_anchors(ra, rv), remap_anchors_plain(ra, rv)),
              f"K2 differs from the plain version at G={g} C={c} NS={ns} "
              f"K={k}")
    torch.cuda.synchronize()
    log(f"K2 ragged (G, C, NS, K) {shapes}: bitwise equal")

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


def phase_k3(flush):
    import torch

    from diner_tpu_torch.kernels import (likelihood_from_chord,
                                         likelihood_from_chord_plain)
    from diner_tpu_torch.kernels.cases import (chord_inputs, max_abs_diff,
                                               with_edge_cases)
    from diner_tpu_torch.kernels.chord import chord_gate

    def on_card(*arrays):
        return (torch.from_numpy(x).cuda() for x in arrays)

    z, scal, vals = on_card(*chord_inputs(3, 1, NV, NR, NC, A))
    ddm = 0.05
    p, ids = likelihood_from_chord(z, scal, vals, A, ddm, return_ids=True)
    p_ref, ids_ref = likelihood_from_chord_plain(z, scal, vals, A, ddm,
                                                 return_ids=True)
    torch.cuda.synchronize()
    check(torch.equal(ids, ids_ref), "K3 anchor ids differ from the plain "
                                     "version's")
    err = (p - p_ref).abs().max().item()
    n_on = chord_gate(z, scal, vals, A, ddm).sum().item()
    off = 1.0 - n_on / (NV * NR * NC)
    log(f"K3 likelihood_from_chord SB=1 NV={NV} NR={NR} NC={NC} A={A}: "
        f"anchor ids bitwise equal; p max abs diff {err:.3e} (<= 2e-6: "
        f"products by 1 / (sqrt2 std) for the divisions, erff vs torch.erf "
        f"ulps); gated off (both erf skipped): {off:.4f} of the (view, "
        f"candidate) pairs")
    check(err <= 2e-6, f"K3 p differs by {err}")
    # ragged shapes: NC not a multiple of 4 (scalar z, p and ids), one and
    # three views, two batch rows, A below a warp and A = 1,024 (32.9 KB of
    # shared memory at NV = 3); std and cos at the edges of the gates
    errs = []
    for i, (nv, a) in enumerate((nv, a) for nv in (1, 3) for a in (8, 1024)):
        rz, rs, rv = chord_inputs(30 + i, 2, nv, 37, 997, a)
        rz, rs, rv = on_card(rz, rs, with_edge_cases(rv, seed=i))
        rp, rids = likelihood_from_chord(rz, rs, rv, a, ddm, return_ids=True)
        rp_ref, rids_ref = likelihood_from_chord_plain(rz, rs, rv, a, ddm,
                                                       return_ids=True)
        check(torch.equal(rids, rids_ref), f"K3 anchor ids differ at NV={nv}"
                                           f" A={a}")
        errs.append(max_abs_diff(rp, rp_ref))
        check(errs[-1] <= 2e-6, f"K3 p differs by {errs[-1]} at NV={nv} "
                                f"A={a}")
    log(f"K3 ragged SB=2 NR=37 NC=997 NV in (1, 3) A in (8, 1024) with edge "
        f"std and cos: anchor ids bitwise equal, p max abs diff "
        f"{max(errs):.3e}, NaN where the plain version's p is NaN")

    ms = time_ms(lambda: likelihood_from_chord(z, scal, vals, A, ddm), flush)
    plain_ms = time_ms(lambda: likelihood_from_chord_plain(
        z, scal, vals, A, ddm), flush)
    n_bytes = 4 * (NR * NC + NV * NR * 8 + NV * NR * 3 * A + NV * NR * NC)
    # the erff run only where the gates pass: count this input's share
    n_ops = ((K3_OPS_PER_CANDIDATE - K3_OPS_ERF) * NV * NR * NC
             + K3_OPS_ERF * n_on)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    log(f"K3 time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB)")
    return dict(name="likelihood_from_chord", route="cuda",
                source="diner_tpu_torch/csrc/chord.cu",
                replaces="diner_tpu/sampler/pallas_likelihood.py:225",
                max_abs_err=err, ms=ms, kernel_ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def phase_k4(flush):
    import torch

    from diner_tpu_torch.kernels import composite_rays, composite_rays_plain

    gen = torch.Generator(device="cuda").manual_seed(4)
    dev = torch.device("cuda")
    B, K = NR, NS
    rays = torch.zeros(1, B, 8, device=dev)
    rays[..., 5], rays[..., 6], rays[..., 7] = 1.0, 1.0, 3.5
    z = torch.sort(torch.rand(1, B, K, generator=gen, device=dev) * 2.5
                   + 1.0, dim=-1).values
    # the field's float32 output: sigmoid rgb, relu sigma (negatives too,
    # to hold the clamp)
    field = torch.rand(1, B * K, 4, generator=gen, device=dev)
    field[..., 3] = torch.randn(1, B * K, generator=gen, device=dev) * 8.0
    err = 0.0
    for white in (False, True):
        got = composite_rays(rays, z, field, white)
        ref = composite_rays_plain(rays, z, field, white)
        torch.cuda.synchronize()
        for name, g, r in zip(("rgb", "depth", "acc"), got, ref):
            e = (g - r).abs()
            err = max(err, e.max().item())
            check(bool((e <= 1e-5 + 1e-5 * r.abs()).all()),
                  f"K4 {name} (white_bkgd={white}) differs by "
                  f"{e.max().item()}")
    log(f"K4 composite_rays B={B} K={K} float32: rgb, depth and acc within "
        f"1e-5 + 1e-5 |plain| (shuffle scan and warp sums in another order),"
        f" max abs diff {err:.3e}, white background off and on")

    ms = time_ms(lambda: composite_rays(rays, z, field), flush)
    plain_ms = time_ms(lambda: composite_rays_plain(rays, z, field), flush)
    n_bytes = 4 * (B * K + B * K * 4 + B + B * 5)
    bound_ms, bound_by = bound(n_bytes, K4_OPS_PER_SAMPLE * B * K)
    log(f"K4 time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.2f} MB)")
    return dict(name="composite_rays", route="cuda",
                source="diner_tpu_torch/csrc/composite.cu",
                replaces="diner_tpu/renderer/pallas_composite.py:76",
                max_abs_err=err, ms=ms, kernel_ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def _serve_requests(server, scene, H, W, seeds, expected, label, card):
    """Requests with every kernel count set to 0 just before and read just
    after each; each must launch exactly `expected` kernels. Returns the
    counts of the whole run and the request times."""
    import torch

    from diner_tpu_torch.kernels import KERNELS

    for k in KERNELS.values():
        k.launches = 0
    counts = {n: [0] for n in KERNELS}
    seconds, image = [], None
    for seed in seeds:
        t = time.perf_counter()
        rgb, depth = server.render("scene0", scene["target_extrinsics"][None],
                                   scene["target_intrinsics"][None], H, W,
                                   seed=seed)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        for n, k in KERNELS.items():
            counts[n].append(k.launches)
        check(tuple(rgb.shape) == (1, H, W, 3), f"rgb shape {rgb.shape}")
        check(bool(torch.isfinite(rgb).all()), "rgb not finite")
        check(rgb.min().item() >= 0.0 and rgb.max().item() <= 1.0,
              "rgb outside [0, 1]")
        check(bool(torch.isfinite(depth).all()), "depth not finite")
        image = rgb if image is None else image
        log(f"{label}: request {seed} {seconds[-1]:.4f} s, "
            f"{H * W / seconds[-1]:.1f} rays/s [{card}]")
    for n, c in counts.items():
        steps = [b - a for a, b in zip(c, c[1:])]
        check(steps == [expected[n]] * len(seeds),
              f"{label}: {n} launches per request {steps}, expected "
              f"{expected[n]} each")
    steady = statistics.median(seconds[1:]) if len(seeds) > 2 \
        else seconds[-1]
    log(f"{label}: {len(seeds)} requests at {H}x{W}, launches per request "
        f"{expected}; steady request {steady:.4f} s = "
        f"{H * W / steady:.1f} rays/s [{card}]")
    return {n: c[-1] for n, c in counts.items()}, image


def _server(preset, hw, card):
    import torch

    from diner_tpu_torch.data import SyntheticSphereDataset
    from diner_tpu_torch.serve import RenderServer

    torch.manual_seed(0)
    ds = SyntheticSphereDataset(n_scenes=1, n_views=NV, H=hw[0], W=hw[1],
                                seed=0)
    scene = ds[0]
    server = RenderServer.from_preset(preset, None, ds.znear, ds.zfar,
                                      buckets=(hw,))
    t = time.perf_counter()
    server.load_scene("scene0", *(scene[k][None] for k in (
        "src_rgbs", "src_depths", "src_depth_stds", "src_extrinsics",
        "src_intrinsics")))
    torch.cuda.synchronize()
    log(f"serve {preset.name}: load_scene (encode {NV} x {hw[0]}x{hw[1]}) "
        f"{time.perf_counter() - t:.3f} s [{card}]")
    return server, scene


def phase_serve(card):
    """The DTU fast preset on both likelihood routes. Returns each kernel's
    launches on its own route."""
    import numpy as np

    server, scene = _server(DTU_PRESET, (H, W), card)
    chunks = -(-H * W // server.cfg.eval_chunk_rays)
    v1, rgb_v1 = _serve_requests(
        server, scene, H, W, range(N_REQUESTS),
        {"likelihood_from_anchors": chunks, "remap_anchors": chunks,
         "likelihood_from_chord": 0, "composite_rays": chunks},
        "serve v1", card)
    server.cfg = dataclasses.replace(server.cfg, likelihood="chord")
    chord, rgb_chord = _serve_requests(
        server, scene, H, W, range(2),
        {"likelihood_from_anchors": 0, "remap_anchors": chunks,
         "likelihood_from_chord": chunks, "composite_rays": chunks},
        "serve chord", card)
    a, b = rgb_v1.cpu().numpy(), rgb_chord.cpu().numpy()
    agree = -10.0 * np.log10(max(float(np.mean((a - b) ** 2)), 1e-20))
    log(f"serve: request 0 on the chord route vs the v1 route (same seed, "
        f"random weights): {agree:.2f} dB")
    return dict(v1, likelihood_from_chord=chord["likelihood_from_chord"])


def phase_facescape(card):
    server, scene = _server(FACESCAPE_PRESET, FACESCAPE_HW, card)
    check(server.cfg.white_bkgd, "the FaceScape preset has a white "
                                 "background")
    chunks = -(-FACESCAPE_HW[0] * FACESCAPE_HW[1]
               // server.cfg.eval_chunk_rays)
    _serve_requests(server, scene, *FACESCAPE_HW, range(2),
                    {"likelihood_from_anchors": chunks,
                     "remap_anchors": chunks, "likelihood_from_chord": 0,
                     "composite_rays": chunks}, "serve facescape", card)


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
             "fast": (fast, dict(n_prior_anchors=96)),
             "fast_chord": (fast, dict(n_prior_anchors=96,
                                       likelihood="chord"))}

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
    check(mean["exact_f32"] > 20.0, "fixture renders garbage")
    for name in ("fast", "fast_chord"):
        delta = mean[name] - mean["exact_f32"]
        log(f"quality: mean PSNR-vs-GT exact {mean['exact_f32']:.4f} dB, "
            f"{name} {mean[name]:.4f} dB, {name} - exact {delta:+.4f} dB "
            f"(gate 0.1 dB)")
        check(abs(delta) <= 0.1, f"{name} path off by {delta:+.4f} dB")


def phase_eval(card):
    """Bulk eval from a reference-layout checkpoint of the random fast-DTU
    model: two synthetic 4-view 256x320 scenes."""
    import numpy as np
    import torch
    import yaml

    from diner_tpu_torch.cli import render_eval
    from diner_tpu_torch.cli.build import build_diner
    from diner_tpu_torch.core.config import load_config
    from diner_tpu_torch.data import SyntheticSphereDataset
    from diner_tpu_torch.kernels import KERNELS
    from diner_tpu_torch.models import to_lightning

    conf = load_config(DTU_PRESET)
    conf["data"] = {"val": {"dataset": {
        "module": "SyntheticSphereDataset",
        "kwargs": {"n_scenes": 2, "n_views": NV, "H": H, "W": W,
                   "seed": 5}}}}
    torch.manual_seed(0)
    model = build_diner(conf, SyntheticSphereDataset.znear,
                        SyntheticSphereDataset.zfar)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        torch.save({"state_dict": to_lightning(model)}, tmp / "model.ckpt")
        (tmp / "eval.yaml").write_text(yaml.safe_dump(conf))
        for k in KERNELS.values():
            k.launches = 0
        t = time.perf_counter()
        scores = render_eval.main([
            "--config", str(tmp / "eval.yaml"), "--torch-ckpt",
            str(tmp / "model.ckpt"), "--out", str(tmp / "out")])
        seconds = time.perf_counter() - t
        pngs = sorted(p.name for p in (tmp / "out" / "visualizations")
                      .iterdir())
        reports = sorted(p.name for p in (tmp / "out").iterdir())
    chunks = 2 * -(-H * W // model.render_cfg.eval_chunk_rays)
    launches = {n: k.launches for n, k in KERNELS.items()}
    log(f"eval: render_eval on 2 scenes at {H}x{W}: {len(pngs)} PNGs, "
        f"reports {reports}, scores {scores}, {seconds:.3f} s in all = "
        f"{seconds / 2:.3f} s per image with loading and scoring "
        f"[{card}]; launches {launches}")
    check(len(pngs) == 8 and all(
        p.endswith(("-pred.png", "-gt.png", "-ref.png", "-depth.png"))
        for p in pngs), f"eval wrote {pngs}")
    check({"average_scores.json", "detailed_report.json",
           "examples.png"} <= set(reports), f"eval reports {reports}")
    check(all(np.isfinite(v) for v in scores.values()),
          f"eval scores not finite: {scores}")
    check(launches == {"likelihood_from_anchors": chunks,
                       "remap_anchors": chunks, "likelihood_from_chord": 0,
                       "composite_rays": chunks},
          f"eval launches {launches}, expected {chunks} of K1, K2, K4")


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
        kernels = [phase_k1(flush), phase_k2(flush), phase_k3(flush),
                   phase_k4(flush)]
        del flush
        launches = phase_serve(card)
        for k in kernels:
            k["launches"] = launches[k["name"]]
        phase_facescape(card)
        phase_quality()
        phase_eval(card)
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
