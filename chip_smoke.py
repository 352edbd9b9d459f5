#!/usr/bin/env python3
"""Build diner_tpu_torch's CUDA kernels and drive the port on one GPU.

Run from the repo root on a machine with a CUDA card and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits nonzero before the
last line:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. nvcc builds every kernel under diner_tpu_torch/csrc/, in parallel,
     and c++ the readers' PNG row defilter (csrc/png_unfilter.cpp);
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
     rgb, depth and acc within 1e-5 + 1e-5 |plain| (the kernel's group scan
     and sums take the products and sums in another order), white
     background off and on; also at ragged shapes (SB 2, B 1001, K 1, 5,
     37, 40 and 64, and each first row alone); times, and an empty launch's
     time on the same timer;
  6b. K4's backward (composite_rays_backward) at the training shape (SB 4,
     B 4096, K 40) vs the gradient of the plain version by autograd, within
     1e-5 + 1e-4 |plain|, white background off and on, about one sigma in 8
     exactly 0 (the relu tie); also at ragged shapes (SB 2, B 1001, K 1, 5,
     37, 40 and 64 in registers, 65 just above the register cap and 1024
     in shared-memory tiles: a partial last block); through the autograd
     Function too; the kernel's registers, shared memory and spills from
     kernels/sass.py; times;
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
  8b. render_options: the fast DTU preset at full width (int8 quad latent
     included) with each latent-fetch variant set in its YAML
     (latent_anchors 8, latent_sample_stride 2, latent_unique_cells 12)
     through from_preset: a warm-up and 2 requests each, K1, K2 and K4 20
     times a request and K3 never, finite rgb; s a request and each
     frame's PSNR against the plain fast render of the same seed;
  8c. pipelined: the fast preset's frame through render_image(split=
     (field_gather, field_mlp)), chunk i+1's sampler and gather on a
     second CUDA stream, against render_image at the same seed: rgb and
     depth within 1e-6, the same launches; s a frame of both and each
     one's device-busy share under torch.profiler;
  8d. sharded: render_image_sharded over ["cuda:0", "cuda:0"] against
     render_image of each shard's rays with that shard's noise: within
     1e-6, 20 launches of K1, K2 and K4 a frame; s a frame;
  9. quality: the trained fixture tests/fixtures/fastpath_tiny.npz, loaded
     with from_jax, renders its held-out scene on the card on the exact f32,
     the fast and the fast chord-route paths and the fast path with each
     latent-fetch variant of 8b (TF32 off), over 16 noise draws: mean
     exact PSNR-vs-GT > 20 dB, |mean fast - mean exact| <= 0.1 dB on each
     fast path (the variants' deltas are printed, not gated: none is
     certified), and each path's first render agrees with the same render
     on the CPU;
  10. bulk eval: the random fast-DTU model goes through to_lightning and
     torch.save, and cli/render_eval renders and scores two synthetic 4-view
     256x320 scenes from that checkpoint: 8 PNGs, finite scores; then
     render_eval --shard-rays on one of them must say that it renders
     unsharded on one device (one card), launch K1, K2 and K4 20 times and
     give finite scores;
  10b. training at full width: cli/train on configs/train_dtu.yaml's nerf,
     renderer and optimizer sections (ResNet34 + group norm, ResnetFC
     512x5 f32, 40 samples from 1000 candidates, VGG 0.1 and antibias 1.0
     on 64x64 patches, Adam at 1e-4) on 36 synthetic 4-view 256x320 scenes,
     batch 4: 8 steps, a save, a resume for 2 more, then render_eval --ckpt
     on one val image. Each step must launch K4 and its backward once and
     K1-K3 never; every loss finite; the checkpoint reloads bitwise; the
     resumed run ends at step 10. Prints steps/s, s/step after warm-up and
     the peak memory, and whether <run>/tb holds TensorBoard events (it
     must exactly when torch.utils.tensorboard imports);
  10b1. ddp_nccl: cli/train --multihost as one NCCL rank (torchrun's
     variables, a free port) and the same run without it, 4 steps at
     batch 4, both exact (deterministic algorithms, cuDNN TF32 off): each
     step's losses within 1e-4 relative, one K4 and one backward a step;
     s/step of both; the gradient all-reduce on one NCCL rank must take
     under 2% of a step;
  10b2. ddp_two_ranks: two ranks (child processes of this script) share the
     card over gloo with CUDA tensors, batch 1 each, against one process
     at batch 2 run first, all exact, on the same global batches and
     draws for 3 steps: global losses within 1e-4 relative, the parameters
     within 1e-6 at 99.9% of the elements after the first step; the last
     step starts everywhere from the reference's own state before it
     (parameters, Adam's moments, the schedule), and after it every
     tensor, ResnetFC's and the encoder's, within 1e-6 at 99.9% of its
     elements and every parameter within 2 lr; the ranks bitwise equal
     (`--ddp-gate-probe` runs the phase sound and with a planted fault,
     the encoder's last step on rank 0's rows alone, which the gate must
     refuse; `--mvs-profiles` profiles the MVS options, phase 10i, apart
     from the main run; `--mvs-ranks-probe` runs phase 10i, then phase
     10j sound and without the ranks' gradient all-reduce, which its
     gates must refuse); then cli/train
     --multihost --logdir in the ranks' group (one run directory, rank 0's
     checkpoints and metrics) for 2 steps and a 2-rank --resume for 1;
     each rank's s/step (two processes on one card: not a scaling
     number), peak memory and K4 launches;
  10c. dtu_eval: a DTU-layout tree of one scan at the dataset's real size
     under build/ (49 MVSNet cams, 343 512x640 images, the source cams'
     uint16 depth and confidence PNGs, their rows filtered adaptively by
     Pillow: the synthetic sphere scene inside the reader's depth range);
     one depth PNG's row filters and decode time; cli/render_eval of the
     fast DTU preset from it
     (random weights from a seed) on 2 images: 20 launches of K1, K2 and K4
     an image, finite scores; the reader's host seconds per sample apart
     from the rest, and the reader alone on four samples;
  10c1. lpips: random LPIPS weights from seed 0 in the JAX package's .npz
     layout; cli/eval_folder score --lpips on the bulk eval phase's folder
     and render_eval --lpips of the fast DTU preset on the DTU tree; each
     image's LPIPS on the card within 1e-5 of the CPU's; ms per image;
  10d. facescape_eval and multiface_eval: a FaceScape tree at 256x256 and a
     MultiFace tree of raw 2048x1334 frames (downsample 8 -> 256x160), meta
     caches and split config in temporary directories; render_eval --n 1 of
     each fast preset: 16 and 10 launches of K1, K2 and K4 an image;
  10e. sweep: create_cam_sweep on the DTU val set, 4 frames of one sweep:
     20 launches of K1, K2 and K4 a frame, an mp4;
  10f. dtu_train: cli/train with train_dtu.yaml's sections on the DTU tree
     (343 metas), batch 4, 3 steps: one K4 and one K4 backward launch a
     step, finite losses; s/step and the loader's seconds per sample;
  10g. mvs: cli/mvs write at the reference DTU width (TransMVSNet, 4 views
     at 512x640, ndepths 48/32/8 of 192, base channels 8, random weights
     from seed 0) on the DTU tree: 4 samples, which overwrite the priors of
     the source cams 30, 10, 6 and 35; the 12 PNGs decoded and checked
     (depth inside the cascade's reach, confidence in [0, 1]); seconds per
     sample after the first, peak memory, and the top ops by device time
     of one sample (torch.profiler); render_eval of the fast DTU preset
     from the new priors, which the reader must read; the card against the
     CPU on one sample with TF32 off (where a stage's hypotheses agree:
     confidence within 1e-4, the same winner wherever the two largest
     probabilities differ by more than 1e-5); cli/mvs eval at 864x1152
     with 5 views on the sphere scene in the MVSNet eval layout, each view
     a reference (its outputs stay for phase 10k). The MVS path launches
     none of K1-K4;
  10h. mvs_train: GT depth PFMs (512x640, mm, masked outside the cam
     files' hypotheses 425-931 mm) of the 34 corner cams added to the DTU
     tree; cli/mvs train at the reference DTU configuration (batch 1,
     random weights from seed 0, 252 samples) for 12 steps with a save
     every 6 and --profile (steps 5-10; the device time by operator and by
     kernel), then --resume to 16: every loss finite, checkpoints at 6, 12
     and 16, Adam's count 12 at the resume and 16 at the end; s/step after
     warm-up and peak memory; one step on the card (TF32 off) against the
     CPU at 512x640 (loss within 1e-3 relative, five tensors' gradients
     within 1e-2 of their largest entry, the BatchNorm statistics within
     1e-5 + 1e-4 relative); write --ckpt from the last checkpoint on the 4
     corner samples (the net holds its state_dict, the PNGs differ from
     phase 10g's); 3 finetune steps (the BlendedMVS layout by default) from
     that checkpoint on a 5-view 576x768 BlendedMVS tree of the sphere
     scene. No kernel launches;
  10i. mvs_options: cli/mvs write at the same width with the gather DCN
     in float32 (phase 10g's priors, again), --dcn-impl window and
     --compute-dtype bfloat16 on the 4 corner samples: s per sample, peak
     memory, and the share of pixels whose depth agrees with the gather
     float32 one (window: within 1e-4 relative; bfloat16: within a tenth
     of stage 3's hypothesis interval); cli/mvs train with window and with
     bfloat16 at batch 1 and 2, 3 steps each: s/step, peak memory, whether
     the batch fits (an out-of-memory is recorded, not hidden) and the
     window offset audit's max |k + offset| on the trained weights;
  10j. mvs_ranks: two gloo ranks sharing the card (child processes of this
     script, cli/mvs train --multihost at batch 1, the cascade in float64,
     its first stage alone, at base channels 2 and cost-regularization
     channels 2 at 512x640: with flat random-weight probabilities the full
     cascade's WTA near-ties move later stages apart under any rounding,
     and two float64 ranks of the full width do not fit beside each other)
     against one process at batch 2, exact, two steps (the second at the
     warmup's first lr above 0): the loss within 1e-6 relative, the global
     gradient (Adam's first moment in the checkpoints) within 5e-2 of each
     tensor's largest entry, or of 1e-3 of the largest overall where a
     tensor's gradient nearly cancels (the float32 softmax's backward
     rounds differently at batch 1 and 2; a missing all-reduce moves the
     gradients by 16 to 430 times their scale), the parameters after the
     second step within a tenth of its lr on 99.9% of the entries (1.0
     sound, 0.55 without the all-reduce, on the H100), the BatchNorm
     statistics within 1e-7 + 1e-7 relative, the ranks bitwise equal; then
     one NCCL rank at the full width in float32, 4 steps: the gradient
     all-reduce under 2% of a step;
  10k. fuse: cli/mvs fuse, normal, dynamic and consensus, on phase 10g's
     eval outputs (5 views at 864x1152, random weights), at the CLI's
     thresholds and at looser ones that keep points: points, s and peak
     memory per scan; the normal method's PLY against the CPU's (counts
     within 1e-3, for pixels at a threshold's rounding, and all but 1e-3
     of the points matched within 1e-5 of the cloud's extent in the same
     colour);
     consensus fusion of a
     49-view DTU scan at 512x640 (the sphere scene): s and peak memory.
     The MVS phases launch none of K1-K4;
  10l. preprocess: the offline preprocessing on the card, on closed
     displaced spheres from seeded numpy draws: render_depth of a
     1,000,000-triangle scan at 4096x3072 (8 views) and render_frame of a
     14,000-triangle tracked mesh at MultiFace's 2048x1334 from a 40-cam
     KRT file: ms per view, triangles/s, peak memory; the card against
     device="cpu" on a 50,000-triangle view at 1024x768 (depths and masks
     equal on at least 99.99% of the pixels, the rest counted);
     facescape_pipeline.process_subject on a raw subject (8 JPEG views at
     4096x3072, the 1M-triangle binary PLY, a similarity alignment), then
     color_calib.calibrate_pose_dir and the FaceScape reader on the
     processed pose: s per view; MultiFace's write_frame_outputs for the
     40 cams and the MultiFace reader on that tree. No kernel launches;
  11. one JSON line {"kernels": [...]} with every kernel's launches on its
     route (phase 7; K1, K2 and K4 add phases 8b-8d's; K4's backward:
     phase 10b; both K4's add the ddp phases'), error and times (K4's entry
     also the empty launch's);
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
# K4's backward per sample: the forward's delta and expf (~12), v (9),
# dalpha/dsigma (2), the row scans of the forward product (3 steps) and of
# the reverse affine maps (3 steps, 3 operations each), the rows' chaining,
# S, g_alpha, g_sigma and the three g_rgb
K4_BWD_OPS_PER_SAMPLE = 45

H, W, NV = 256, 320, 4   # the DTU evaluation image and its source views
FACESCAPE_HW = (256, 256)
N_REQUESTS = 3           # on the v1 route; the chord route and FaceScape: 2
# one render's fast - exact PSNR delta moves by ~0.1 dB with the noise draw
# alone (measured on the CPU over 12 draws: -0.16 .. +0.04 dB, mean
# -0.06 dB), so the gate holds the mean over several draws
QUALITY_SEEDS = 16
NR = 4096                # rays per chunk of the preset
# the latent-fetch variants on the fast preset (bench.py:196's turbo knob,
# the stride the int8 latent's fix concerns, unique cells), timed requests
RENDER_VARIANTS = {"turbo": {"latent_anchors": 8},
                   "stride2": {"latent_sample_stride": 2},
                   "unique12": {"latent_unique_cells": 12}}
OPTION_REQUESTS = 2
G, NC, A, NS = 1 * NV * NR, 1000, 256, 32   # one chunk of the preset
TRAIN_CONFIG = ROOT / "configs" / "train_dtu.yaml"
# a training step of train_dtu.yaml: SB scenes, one 64x64 patch each,
# 40 samples a ray
TRAIN_SB, TRAIN_K = 4, 40
TRAIN_B = 64 * 64
TRAIN_STEPS, RESUME_STEPS = 8, 2
TRAIN_REMAT = False      # remat_field off: batch 4 fits in 80 GB
MULTIFACE_PRESET = ROOT / "configs" / "evaluate_diner_on_multiface_fast.yaml"
# the dataset phases' trees, under the gitignored build/
DATA_DIR = ROOT / "build" / "chip_smoke_data"
DTU_DOWNSAMPLE = 0.5     # the DTU reader's default: 256x320 images
# the DTU tree's cams look at the sphere scene from DTU_CAM_RADIUS; the
# scene scaled by DTU_SCENE_SCALE reaches at most 0.37 from the origin, so
# its depths lie in [0.39, 1.13], inside the reader's [0.321, 1.204]
DTU_CAM_RADIUS, DTU_SCENE_SCALE = 0.76, 0.3
MULTIFACE_RAW = (2048, 1334)   # MultiFace's frames, H x W
SWEEP_FRAMES = 4
DTU_TRAIN_STEPS = 3
MVS_EVAL_HW = (864, 1152)   # GeneralEvalMVSDataset's caps
MVS_EVAL_VIEWS = 5          # each a reference of the 4 others
MVS_TOP_OPS = 10
# MVS training at the reference DTU configuration: the train run, its save
# interval and the resume; the BlendedMVS tree's images (its low-res size);
# the card against the CPU on one step
MVS_NUMDEPTH = 192
MVS_TRAIN_STEPS, MVS_SAVE_EVERY, MVS_RESUME_STEPS = 12, 6, 4
MVS_FINETUNE_STEPS = 3
BLD_HW = (576, 768)
MVS_GRAD_CHECK = ("cost_regularization.0.prob.weight",
                  "cost_regularization.2.prob.weight",
                  "DepthNet.pixel_wise_net.conv2.weight",
                  "FMT_with_pathway.smooth_2.weight",
                  "feature.out3.7.weight")
# the MVS options' training runs; MVS training across ranks: two gloo
# ranks with the cascade in float64 and its first stage alone (see
# phase_mvs_ranks) at a quarter of the channels (two float64 ranks of the
# full width do not fit one card beside each other), then one NCCL rank
# at the full width in float32
MVS_OPTION_STEPS = 3
MVS_RANK_STEPS, MVS_NCCL_STEPS = 2, 4
MVS_RANK_WIDTH = ("--ndepths", "48", "--depth_inter_r", "4",
                  "--base_channels", "2", "--cr_base_chs", "2")
# two ranks' loss and global gradient against one process's: the loss
# relative, each tensor's gradient within this share of its largest entry.
# The softmax stays float32: on the H100 its backward rounds differently at
# batch 1 and 2, and the cascade's gradients, sums that cancel to a small
# part of their terms, carry that as up to 6.5e-3 of a tensor's largest
# entry; without the gradient all-reduce the H100 read 16 to 430 times a
# tensor's scale
MVS_RANK_LOSS_TOL, MVS_RANK_GRAD_TOL = 1e-6, 5e-2
# the share of parameter entries within a tenth of the last step's lr of
# the reference's after MVS_RANK_STEPS: 1.000000 on the H100 (the largest
# difference 0.057 lr), 0.551767 without the gradient all-reduce
MVS_RANK_PARAM_SHARE = 0.999
# fuse's thresholds at which random weights' eval outputs keep points
FUSE_LOOSE = ["--conf", "0", "--thres_view", "1", "--num_consistent", "1"]
DDP_NCCL_STEPS = 4
# the exact comparison's batch: the deterministic scatter of the field's
# gathers needs int64 indices as large as the gathered rows (20 GiB more at
# batch 4, beyond the card's 80 GB)
DDP_EXACT_SB = 2
# two ranks on one card: explicit-draw steps, then cli/train's steps and
# its resume
DDP_STEPS, DDP_CLI_STEPS, DDP_RESUME_STEPS = 3, 2, 1
DDP_CHILD_TIMEOUT = 600
# card vs CPU LPIPS of one image, TF32 off: VGG16's f32 convolutions in
# other algorithms and orders of sums
LPIPS_TOL = 1e-5
# the preprocessing phase's meshes, closed displaced UV spheres of
# 2 n_lon (n_lat - 1) triangles: a FaceScape scan (about 1M), a MultiFace
# tracked mesh (about 14k) and the card-vs-CPU check's (50k); the raw
# FaceScape views (H x W), their count and focal; MultiFace's cams
PRE_SCAN_GRID, PRE_TRACKED_GRID, PRE_CHECK_GRID = (501, 1000), (71, 100), \
    (126, 200)
PRE_RAW_HW, PRE_VIEWS, PRE_RAW_FOCAL = (3072, 4096), 8, 7500.0
PRE_CHECK_HW = (768, 1024)
PRE_MF_CAMS, PRE_MF_FOCAL = (8, 5), 4000.0     # az x el grid
# card vs CPU: pixels equal after the float32 cast, at least this share
PRE_AGREE = 0.9999


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

    from diner_tpu_torch.kernels.build import host_library

    t = time.perf_counter()
    build_all()
    log(f"build: nvcc {kernel_sources()} in {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    host_library("png_unfilter")
    log(f"build: c++ png_unfilter (the readers' PNG row defilter) in "
        f"{time.perf_counter() - t:.2f} s")


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
    from diner_tpu_torch.kernels.cases import composite_inputs
    from diner_tpu_torch.kernels.composite import GROUP, THREADS

    def on_card(seed, SB, B, K):
        return [torch.from_numpy(x).cuda()
                for x in composite_inputs(seed, SB, B, K)]

    def compare(rays, z, field):
        err = 0.0
        for white in (False, True):
            got = composite_rays(rays, z, field, white)
            ref = composite_rays_plain(rays, z, field, white)
            torch.cuda.synchronize()
            for name, g, r in zip(("rgb", "depth", "acc"), got, ref):
                e = (g - r).abs()
                err = max(err, e.max().item())
                check(bool((e <= 1e-5 + 1e-5 * r.abs()).all()),
                      f"K4 {name} (white_bkgd={white}) at {tuple(z.shape)} "
                      f"differs by {e.max().item()}")
        return err

    B, K = NR, NS
    rays, z, field = on_card(4, 1, B, K)
    err = compare(rays, z, field)
    log(f"K4 composite_rays B={B} K={K} float32: rgb, depth and acc within "
        f"1e-5 + 1e-5 |plain| (group scan and sums in another order), max "
        f"abs diff {err:.3e}, white background off and on")
    # ragged shapes: K below, at and above a 32-sample tile and odd; rays
    # that do not fill the last block, and (the first row alone) a group
    # past the last ray in the last warp
    ragged = (1, 5, 37, 40, 64)
    check(2 * 1001 % (THREADS // GROUP) != 0 and 1001 % (32 // GROUP) != 0,
          "the rays fill the last block or warp")
    errs = []
    for k in ragged:
        inputs = on_card(40 + k, 2, 1001, k)
        errs += [compare(*inputs), compare(*(t[:1] for t in inputs))]
    log(f"K4 ragged SB=2 B=1001 (and its first row alone) K in {ragged}: "
        f"within 1e-5 + 1e-5 |plain|, max abs diff {max(errs):.3e}, white "
        f"background off and on")

    ms = time_ms(lambda: composite_rays(rays, z, field), flush)
    plain_ms = time_ms(lambda: composite_rays_plain(rays, z, field), flush)
    empty_ms = time_ms(lambda: torch.cuda._sleep(0), flush)
    n_bytes = 4 * (B * K + B * K * 4 + B + B * 5)
    bound_ms, bound_by = bound(n_bytes, K4_OPS_PER_SAMPLE * B * K)
    log(f"K4 time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.2f} MB)")
    log(f"empty launch (torch.cuda._sleep(0)) on the same timer: "
        f"{empty_ms:.4f} ms")
    return dict(name="composite_rays", route="cuda",
                source="diner_tpu_torch/csrc/composite.cu",
                replaces="diner_tpu/renderer/pallas_composite.py:76",
                max_abs_err=err, ms=ms, kernel_ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, empty_ms=empty_ms)


def phase_k4_backward(flush):
    import torch

    from diner_tpu_torch.kernels import (KERNELS, composite_rays,
                                         composite_rays_backward,
                                         composite_rays_backward_plain)
    from diner_tpu_torch.kernels.cases import composite_grad_inputs
    from diner_tpu_torch.kernels.composite import (BACKWARD_GROUP,
                                                   BACKWARD_MAX_PER_LANE,
                                                   backward_geometry)
    from diner_tpu_torch.kernels.sass import report

    def on_card(seed, SB, B, K):
        return [torch.from_numpy(x).cuda()
                for x in composite_grad_inputs(seed, SB, B, K)]

    def compare(rays, z, field, *grads):
        err = 0.0
        for white in (False, True):
            got = composite_rays_backward(rays, z, field, *grads, white)
            ref = composite_rays_backward_plain(rays, z, field, *grads,
                                                white)
            torch.cuda.synchronize()
            e = (got - ref).abs()
            err = max(err, e.max().item())
            check(bool((e <= 1e-5 + 1e-4 * ref.abs()).all()),
                  f"K4 backward (white_bkgd={white}) at {tuple(z.shape)} "
                  f"differs by {e.max().item()}")
        return err

    SB, B, K = TRAIN_SB, TRAIN_B, TRAIN_K
    inputs = on_card(5, SB, B, K)
    err = compare(*inputs)
    log(f"K4 backward composite_rays_backward SB={SB} B={B} K={K}: g_field "
        f"within 1e-5 + 1e-4 |plain| of autograd through the plain version "
        f"(scans in another order), max abs diff {err:.3e}, white "
        f"background off and on, 1 sigma in 8 exactly 0")
    # K odd, below, at and above the register cap (one tile of
    # BACKWARD_GROUP * BACKWARD_MAX_PER_LANE samples), and 1024 (tiles in
    # shared memory)
    cap = BACKWARD_GROUP * BACKWARD_MAX_PER_LANE
    ragged = (1, 5, 37, 40, 64, cap + 1, 1024)
    check(all(2 * 1001 * BACKWARD_GROUP % backward_geometry(2 * 1001, k)[1]
              for k in ragged), "the rays fill the last block")
    errs = [compare(*on_card(50 + k, 2, 1001, k)) for k in ragged]
    shared = [backward_geometry(2 * 1001, k)[2] for k in ragged]
    log(f"K4 backward ragged SB=2 B=1001 K in {ragged} (register cap {cap}; "
        f"shared memory {shared} B): within 1e-5 + 1e-4 |plain|, max abs "
        f"diff {max(errs):.3e}")
    with tempfile.TemporaryDirectory() as tmp:
        for func, k in report("composite_bwd", ROOT / "diner_tpu_torch"
                              / "csrc", Path(tmp))["kernels"].items():
            log(f"K4 backward {func}: {k.get('registers')} registers, "
                f"{k.get('smem')} B static shared memory, spills "
                f"{k.get('spill_stores')}/{k.get('spill_loads')} B, "
                f"{k['instructions']} SASS instructions")
    # through the autograd Function: one forward and one backward launch
    rays, z, field, g_rgb, g_depth, g_acc = inputs
    before = (KERNELS["composite_rays"].launches,
              KERNELS["composite_rays_backward"].launches)
    leaf = field.clone().requires_grad_(True)
    outs = composite_rays(rays, z, leaf)
    torch.autograd.backward(outs, (g_rgb, g_depth, g_acc))
    torch.cuda.synchronize()
    check((KERNELS["composite_rays"].launches,
           KERNELS["composite_rays_backward"].launches)
          == (before[0] + 1, before[1] + 1),
          "composite_rays with grad did not launch K4 and its backward once")
    check(torch.equal(leaf.grad, composite_rays_backward(
        rays, z, field, g_rgb, g_depth, g_acc)),
        "the Function's gradient differs from the backward kernel's")
    log("K4 backward through autograd (CompositeFunction): one forward and "
        "one backward launch, gradient bitwise the kernel's")

    ms = time_ms(lambda: composite_rays_backward(*inputs), flush)
    plain_ms = time_ms(lambda: composite_rays_backward_plain(*inputs), flush)
    n = SB * B * K
    n_bytes = 4 * (n + 4 * n + SB * B * (1 + 5) + 4 * n)
    bound_ms, bound_by = bound(n_bytes, K4_BWD_OPS_PER_SAMPLE * n)
    log(f"K4 backward time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.2f} MB)")
    return dict(name="composite_rays_backward", route="cuda",
                source="diner_tpu_torch/csrc/composite_bwd.cu",
                replaces="diner_tpu/renderer/pallas_composite.py:76",
                max_abs_err=max([err] + errs), ms=ms, kernel_ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None,
                gradient_of="jax.grad of diner_tpu/renderer/composite.py:25")


def _serve_requests(server, scene, H, W, seeds, expected, label, card):
    """Requests with every kernel count set to 0 just before and read just
    after each; each must launch exactly `expected` kernels. Returns the
    counts of the whole run, each request's rgb and the steady request
    time."""
    import torch

    from diner_tpu_torch.kernels import KERNELS

    for k in KERNELS.values():
        k.launches = 0
    counts = {n: [0] for n in KERNELS}
    seconds, images = [], []
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
        images.append(rgb)
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
    return {n: c[-1] for n, c in counts.items()}, images, steady


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
    v1, rgb_v1, _ = _serve_requests(
        server, scene, H, W, range(N_REQUESTS),
        {"likelihood_from_anchors": chunks, "remap_anchors": chunks,
         "likelihood_from_chord": 0, "composite_rays": chunks,
         "composite_rays_backward": 0}, "serve v1", card)
    server.cfg = dataclasses.replace(server.cfg, likelihood="chord")
    chord, rgb_chord, _ = _serve_requests(
        server, scene, H, W, range(2),
        {"likelihood_from_anchors": 0, "remap_anchors": chunks,
         "likelihood_from_chord": chunks, "composite_rays": chunks,
         "composite_rays_backward": 0}, "serve chord", card)
    a, b = rgb_v1[0].cpu().numpy(), rgb_chord[0].cpu().numpy()
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
                     "composite_rays": chunks,
                     "composite_rays_backward": 0}, "serve facescape", card)


def _variant_preset(tmp: Path, name: str, knobs) -> Path:
    """The fast DTU preset with `knobs` added to its nerf kwargs, as a YAML
    file: the variant goes through from_preset and cli/build as a user's
    preset would."""
    import yaml

    from diner_tpu_torch.core.config import load_config

    conf = load_config(DTU_PRESET)
    conf["nerf"]["kwargs"].update(knobs)
    path = tmp / f"{name}.yaml"
    path.write_text(yaml.safe_dump(conf))
    return path


def _psnr_db(a, b):
    import numpy as np

    mse = float(np.mean((a.cpu().numpy() - b.cpu().numpy()) ** 2))
    return float(-10.0 * np.log10(max(mse, 1e-20)))


def phase_render_options(card):
    """The three latent-fetch variants on the full-width fast DTU preset
    (int8 quad latent included), random weights from seed 0: a warm-up and
    2 requests each, K1, K2 and K4 20 times a request and K3 never; each
    frame's PSNR against the plain fast render of the same seed (the same
    draws). Returns the kernels' launches of the timed requests."""
    from diner_tpu_torch.kernels import KERNELS

    chunks = -(-H * W // NR)
    expected = {"likelihood_from_anchors": chunks, "remap_anchors": chunks,
                "likelihood_from_chord": 0, "composite_rays": chunks,
                "composite_rays_backward": 0}
    seeds = range(1, 1 + OPTION_REQUESTS)
    launches = {n: 0 for n in KERNELS}
    server, scene = _server(DTU_PRESET, (H, W), card)
    _, plain, plain_s = _serve_requests(server, scene, H, W, seeds,
                                        expected, "render_options plain",
                                        card)
    del server
    with tempfile.TemporaryDirectory() as tmp:
        for name, knobs in RENDER_VARIANTS.items():
            server, scene = _server(_variant_preset(Path(tmp), name, knobs),
                                    (H, W), card)
            check(all(getattr(server.model, k) == v
                      for k, v in knobs.items()),
                  f"{name}: the preset's {knobs} did not reach the model")
            _serve_requests(server, scene, H, W, [0], expected,
                            f"render_options {name} warm-up", card)
            counts, images, steady = _serve_requests(
                server, scene, H, W, seeds, expected,
                f"render_options {name}", card)
            for n in launches:
                launches[n] += counts[n]
            agree = [_psnr_db(a, b) for a, b in zip(images, plain)]
            log(f"render_options {name} {knobs}: {steady:.4f} s a request "
                f"(plain fast {plain_s:.4f} s), PSNR against the plain fast "
                f"render of the same draws {[round(x, 2) for x in agree]} "
                f"dB [{card}]")
            del server
            gc_cuda()
    return launches


def _frame(server, scene):
    """The rays of the scene's target view at the server's bucket and the
    encoding of its loaded scene."""
    import torch

    from diner_tpu_torch.geometry import gen_rays

    dev = server.device
    ext = torch.as_tensor(scene["target_extrinsics"][None], device=dev)
    K = torch.as_tensor(scene["target_intrinsics"][None], device=dev)
    rays = gen_rays(ext, K, W, H, torch.full((1,), server.znear, device=dev),
                    torch.full((1,), server.zfar, device=dev))
    return rays, server._scenes["scene0"]


def phase_pipelined(card):
    """The fast preset's frame through render_image(split=(field_gather,
    field_mlp)), the sampler and gather of chunk i+1 on a second stream
    beside chunk i's MLP and compositing, against render_image at the same
    seed (the same draws): rgb and depth within 1e-6 and the same
    launches; s a frame of both, and each one's device-busy share under
    torch.profiler (the summed device time of all kernels over the wall
    time, as profile_serve reads it). Returns the pipelined frames'
    launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from diner_tpu_torch.renderer import render_image
    from diner_tpu_torch.utils.profiling import device_tables

    server, scene = _server(DTU_PRESET, (H, W), card)
    rays, enc = _frame(server, scene)
    model, cfg = server.model, server.cfg
    split = (lambda p, aux: model.field_gather(enc, p, aux),
             lambda g, p, d: model.field_mlp(enc, g, p, d))
    renders = {
        "chunked": lambda seed: render_image(
            lambda p, d, aux: model.field(enc, p, d, aux), rays, enc, cfg,
            chunk=server.chunk, seed=seed),
        "pipelined": lambda seed: render_image(
            None, rays, enc, cfg, chunk=server.chunk, seed=seed,
            split=split)}
    chunks = -(-H * W // server.chunk)
    out, seconds, counts = {}, {}, {}
    for name, fn in renders.items():
        fn(0)   # warm-up
        torch.cuda.synchronize()
        _zero_launches()
        seconds[name] = []
        for seed in range(1, 1 + OPTION_REQUESTS):
            t = time.perf_counter()
            out[name] = fn(seed)
            torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t)
        counts[name] = _launches()
        check(counts[name] == _expect(*(OPTION_REQUESTS * chunks,) * 3),
              f"pipelined: {name} launches {counts[name]}")
    for key, a, b in zip(("rgb", "depth"), out["pipelined"],
                         out["chunked"]):
        err = (a - b).abs().max().item()
        log(f"pipelined: {key} of the last frame, pipelined vs chunked, max "
            f"abs {err:.3g} (gate 1e-6)")
        check(err <= 1e-6, f"pipelined {key} differs by {err}")
    check(counts["pipelined"] == counts["chunked"],
          "pipelined and chunked launches differ")
    busy = {}
    for name, fn in renders.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn(9)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        busy[name] = (device_tables(prof)[2] / 1e6, wall)
    for name in renders:
        log(f"pipelined: {name} {[round(x, 4) for x in seconds[name]]} s a "
            f"frame at {H}x{W}; under the profiler {busy[name][1]:.4f} s, "
            f"device busy {busy[name][0]:.4f} s = "
            f"{busy[name][0] / busy[name][1]:.3f} [{card}]")
    del server
    gc_cuda()
    return counts["pipelined"]


def phase_sharded(card):
    """render_image_sharded over ["cuda:0", "cuda:0"] (two shards of 40,960
    rays on the one card) against render_image of each shard's rays, each
    shard's noise passed to both: rgb and depth within 1e-6, and 20
    launches of K1, K2 and K4 a frame. Returns the sharded frame's
    launches."""
    import torch

    from diner_tpu_torch.renderer import render_image, render_image_sharded
    from diner_tpu_torch.renderer.sharded import shard_rays

    server, scene = _server(DTU_PRESET, (H, W), card)
    rays, enc = _frame(server, scene)
    model, cfg = server.model, server.cfg
    devices = ["cuda:0", "cuda:0"]
    per = -(-H * W // len(devices))
    gen = torch.Generator(device="cuda").manual_seed(0)
    noise = [[(torch.rand(1, NR, cfg.n_depth_candidates, generator=gen,
                          device="cuda"),
               torch.randn(1, NR, cfg.n_gaussian, generator=gen,
                           device="cuda"),
               torch.rand(1, NR, cfg.n_samples, generator=gen,
                          device="cuda"))
              for _ in range(-(-per // NR))] for _ in devices]

    def field(e, p, d, aux=None):
        return model.field(e, p, d, aux)

    render_image_sharded(field, rays, enc, cfg, devices, chunk=NR,
                         noise=noise)   # warm-up
    torch.cuda.synchronize()
    _zero_launches()
    t = time.perf_counter()
    rgb, depth = render_image_sharded(field, rays, enc, cfg, devices,
                                      chunk=NR, noise=noise)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = _launches()
    chunks = len(devices) * -(-per // NR)
    check(launches == _expect(chunks, chunks, chunks),
          f"sharded launches {launches}, expected {chunks} of K1, K2, K4")
    shards = shard_rays(rays, len(devices))
    ref = [render_image(lambda p, d, aux: model.field(enc, p, d, aux),
                        shards[i][:, None], enc, cfg, chunk=NR,
                        noise=noise[i]) for i in range(len(devices))]
    ref_rgb = torch.cat([r[0].reshape(1, per, 3) for r in ref], 1)[:, :H * W]
    ref_depth = torch.cat([r[1].reshape(1, per) for r in ref], 1)[:, :H * W]
    err = max((rgb.reshape(1, -1, 3) - ref_rgb).abs().max().item(),
              (depth.reshape(1, -1) - ref_depth).abs().max().item())
    log(f"sharded: {len(devices)} shards on {devices} at {H}x{W}: "
        f"{seconds:.4f} s a frame, launches {launches}; against "
        f"render_image of each shard max abs {err:.3g} (gate 1e-6) [{card}]")
    check(err <= 1e-6, f"sharded render differs by {err}")
    check(bool(torch.isfinite(rgb).all()), "sharded rgb not finite")
    del server
    gc_cuda()
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
    import torch

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("quality: TF32 off for convolutions and matmuls in this phase")
    try:
        _quality_renders()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def _quality_renders():
    import numpy as np
    import torch

    from diner_tpu_torch.core import RenderConfig
    from diner_tpu_torch.data import SyntheticSphereDataset, collate
    from diner_tpu_torch.models import DINER, PixelNeRF, from_jax

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
    # the latent-fetch variants on the fast path: recorded, not gated at
    # 0.1 dB (none is certified)
    paths.update({name: (dict(fast, **knobs), dict(n_prior_anchors=96))
                  for name, knobs in RENDER_VARIANTS.items()})

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
    for name in RENDER_VARIANTS:
        log(f"quality: {name} mean PSNR-vs-GT {mean[name]:.4f} dB, "
            f"{name} - exact {mean[name] - mean['exact_f32']:+.4f} dB, "
            f"{name} - fast {mean[name] - mean['fast']:+.4f} dB (not gated)")
    for name in ("fast", "fast_chord"):
        delta = mean[name] - mean["exact_f32"]
        log(f"quality: mean PSNR-vs-GT exact {mean['exact_f32']:.4f} dB, "
            f"{name} {mean[name]:.4f} dB, {name} - exact {delta:+.4f} dB "
            f"(gate 0.1 dB)")
        check(abs(delta) <= 0.1, f"{name} path off by {delta:+.4f} dB")


def phase_eval(card, keep: Path):
    """Bulk eval from a reference-layout checkpoint of the random fast-DTU
    model: two synthetic 4-view 256x320 scenes. The output folder is copied
    to `keep` (the lpips phase scores it again)."""
    import shutil

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
        shutil.copytree(tmp / "out", keep)
        launches = {n: k.launches for n, k in KERNELS.items()}
        _eval_shard_rays(tmp, card)
    chunks = 2 * -(-H * W // model.render_cfg.eval_chunk_rays)
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
                       "composite_rays": chunks,
                       "composite_rays_backward": 0},
          f"eval launches {launches}, expected {chunks} of K1, K2, K4")


def _eval_shard_rays(tmp: Path, card):
    """render_eval --shard-rays --n 1 on the bulk eval phase's config and
    checkpoint: with one card it must say that it renders unsharded on one
    device, launch K1, K2 and K4 20 times and give finite scores."""
    import contextlib
    import io

    import numpy as np

    from diner_tpu_torch.cli import render_eval

    _zero_launches()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        scores = render_eval.main([
            "--config", str(tmp / "eval.yaml"), "--torch-ckpt",
            str(tmp / "model.ckpt"), "--out", str(tmp / "out_shard"),
            "--n", "1", "--shard-rays"])
    print(text.getvalue(), end="", flush=True)
    launches = _launches()
    chunks = -(-H * W // NR)
    log(f"sharded: render_eval --shard-rays on one image: scores {scores}, "
        f"launches {launches} [{card}]")
    check("rendering unsharded on one device" in text.getvalue(),
          "render_eval --shard-rays did not say it renders unsharded")
    check(all(np.isfinite(v) for v in scores.values()),
          f"render_eval --shard-rays scores not finite: {scores}")
    check(launches == _expect(chunks, chunks, chunks),
          f"render_eval --shard-rays launches {launches}")


def _train_config(tmp: Path, batch_size: int,
                  name: str = "train.yaml") -> Path:
    """train_dtu.yaml with its data on synthetic 4-view 256x320 scenes and
    no validation in the loop; nerf, renderer and optimizer as they are."""
    import yaml

    from diner_tpu_torch.core.config import load_config

    conf = load_config(TRAIN_CONFIG)
    # 36 scenes: the batch the loop drops (as the JAX loop spends it on
    # initialization) and the 8 steps are one epoch at batch 4, so that no
    # timed step waits for the loader to start an epoch (the first batch of
    # an epoch is not prefetched)
    data = {"module": "SyntheticSphereDataset",
            "kwargs": {"n_scenes": 36, "n_views": NV, "H": H, "W": W,
                       "seed": 0}}
    conf["data"] = {
        "train": {"dataset": data, "dataloader": {"kwargs": {
            "batch_size": batch_size, "shuffle": True, "num_workers": 4}}},
        "val": {"dataset": dict(data, kwargs=dict(data["kwargs"],
                                                  n_scenes=1, seed=7))}}
    conf["trainer"] = {"kwargs": {"max_steps": TRAIN_STEPS,
                                  "val_check_interval": None}}
    if TRAIN_REMAT:
        conf["nerf"]["kwargs"]["remat_field"] = True
    path = tmp / name
    path.write_text(yaml.safe_dump(conf))
    return path


def phase_train(card):
    """cli/train at train_dtu.yaml's widths; returns K4's backward
    launches of the run, its metrics lines and its median s/step after
    warm-up."""
    import numpy as np
    import torch

    from diner_tpu_torch.cli import render_eval
    from diner_tpu_torch.cli import train as train_cli
    from diner_tpu_torch.kernels import KERNELS

    log(f"train: TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, TF32 "
        f"cuDNN {torch.backends.cudnn.allow_tf32}, "
        f"remat_field {TRAIN_REMAT}, batch {TRAIN_SB}")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg = _train_config(tmp, TRAIN_SB)
        run = tmp / "run"
        for k in KERNELS.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        state = train_cli.main([str(cfg), "--run-dir", str(run),
                                "--log-every", "1"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        launches = {n: k.launches for n, k in KERNELS.items()}
        check(launches == {"likelihood_from_anchors": 0, "remap_anchors": 0,
                           "likelihood_from_chord": 0,
                           "composite_rays": TRAIN_STEPS,
                           "composite_rays_backward": TRAIN_STEPS},
              f"train launches {launches}, expected one K4 and one K4 "
              f"backward a step")
        lines = [json.loads(x) for x in
                 (run / "metrics.jsonl").read_text().splitlines()]
        check([x["step"] for x in lines] == list(range(TRAIN_STEPS)),
              f"metrics steps {[x['step'] for x in lines]}")
        for x in lines:
            check(all(np.isfinite(v) for v in x.values()),
                  f"non-finite metrics {x}")
            check(x["skipped_nonfinite"] == 0.0, f"skipped step {x}")
        s_step = [1.0 / x["steps_per_sec"] for x in lines]
        steady = statistics.median(s_step[2:])
        tb_files = sorted(p.name for p in (run / "tb").iterdir()) \
            if (run / "tb").is_dir() else []
        check(bool(tb_files) == _tensorboard_importable(),
              f"train: tb/ holds {tb_files}, but torch.utils.tensorboard "
              f"imports: {_tensorboard_importable()}")
        log(f"tensorboard: " + (
            f"events written under <run>/tb ({tb_files})" if tb_files else
            "no events under <run>/tb: torch.utils.tensorboard does not "
            "import (no tensorboard package here), metrics.jsonl only"))
        log(f"train: {TRAIN_STEPS} steps in {seconds:.2f} s with set-up; "
            f"totals {[round(x['total'], 5) for x in lines]}")
        log(f"train: s/step {[round(v, 4) for v in s_step]}; after warm-up "
            f"(steps 2-{TRAIN_STEPS - 1}) median {steady:.4f} s/step = "
            f"{1.0 / steady:.3f} steps/s; peak memory "
            f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated) [{card}]")

        ckpt = run / "ckpts" / f"step_{TRAIN_STEPS:08d}.pt"
        payload = torch.load(ckpt, map_location="cpu", weights_only=True)
        own = state.model.nerf.state_dict()
        check(payload["step"] == TRAIN_STEPS and payload["nerf"].keys()
              == own.keys() and all(torch.equal(payload["nerf"][k], v.cpu())
                                    for k, v in own.items()),
              "the checkpoint does not reload the model bitwise")
        opt = state.optimizer.state_dict()["state"]
        check(all(torch.equal(payload["optimizer"]["state"][i][n], t.cpu())
                  for i, st in opt.items() for n, t in st.items()),
              "the checkpoint does not reload Adam's state bitwise")
        log(f"train: checkpoint {ckpt.name} reloads the parameters, norm "
            f"buffers and Adam's state bitwise")

        state = train_cli.main([str(cfg), "--run-dir", str(run), "--resume",
                                "--max-steps",
                                str(TRAIN_STEPS + RESUME_STEPS),
                                "--log-every", "1"])
        torch.cuda.synchronize()
        done = TRAIN_STEPS + RESUME_STEPS
        adam_step = {float(st["step"]) for st in
                     state.optimizer.state_dict()["state"].values()}
        check(state.step == done and adam_step == {float(done)}
              and state.scheduler.last_epoch == done,
              f"resumed run ends at step {state.step}, Adam {adam_step}, "
              f"schedule {state.scheduler.last_epoch}, expected {done}")
        check(KERNELS["composite_rays"].launches == done
              and KERNELS["composite_rays_backward"].launches == done,
              "the resumed steps did not launch K4 and its backward once")
        steps = [json.loads(x)["step"] for x in
                 (run / "metrics.jsonl").read_text().splitlines()]
        check(steps == list(range(done)), f"metrics after resume: {steps}")
        log(f"train: resumed from step {TRAIN_STEPS} for {RESUME_STEPS} "
            f"steps (no step replayed), Adam and the schedule at {done}")
        backward_launches = KERNELS["composite_rays_backward"].launches
        first_run = lines

        for k in KERNELS.values():
            k.launches = 0
        out = tmp / "eval"
        scores = render_eval.main(["--config", str(cfg), "--ckpt",
                                   str(run / "ckpts"), "--out", str(out),
                                   "--n", "1"])
        pngs = sorted(p.name for p in (out / "visualizations").iterdir())
        chunks = -(-H * W // 8192)
        log(f"train: render_eval --ckpt on one val image: {pngs}, scores "
            f"{scores}, launches "
            f"{ {n: k.launches for n, k in KERNELS.items()} }")
        check(len(pngs) == 4 and all(np.isfinite(v) for v in scores.values()),
              f"render_eval --ckpt wrote {pngs}, scores {scores}")
        check(KERNELS["composite_rays"].launches == chunks
              and KERNELS["composite_rays_backward"].launches == 0,
              f"render_eval launched K4 {KERNELS['composite_rays'].launches}"
              f" times, expected {chunks}")
    return backward_launches, first_run, steady


def _tensorboard_importable() -> bool:
    try:
        import torch.utils.tensorboard  # noqa: F401
    except ImportError:
        return False
    return True


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ddp_env(port: int, rank: int = 0, world: int = 1):
    """torchrun's variables for `rank` of `world` on this machine; every
    rank on cuda:0, the one card."""
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
            "WORLD_SIZE": str(world), "RANK": str(rank), "LOCAL_RANK": "0"}


LOSS_KEYS = ("rgb_fine", "vgg_fine", "antibias", "total")


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


class _Exact:
    """torch's deterministic algorithms (cuDNN's too, cuBLAS with a fixed
    workspace) and no TF32 in cuDNN's convolutions while active: the same
    inputs give the same bits run to run, and another batch size (another
    cuDNN algorithm) rounds as float32 does, so that two training runs
    differ only where their programs do.
    Without it, the card's run-to-run differences (atomic sums in the
    backward pass) grow through Adam's steps: on the H100 a one-rank NCCL
    run and a single-process run of the training phase's config, neither
    deterministic, read losses 2.6e-4 apart (relative) by the third
    step."""

    def __enter__(self):
        import os

        import torch

        self.saved = (torch.are_deterministic_algorithms_enabled(),
                      torch.backends.cudnn.deterministic,
                      torch.backends.cudnn.benchmark,
                      torch.backends.cudnn.allow_tf32,
                      os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        import os

        import torch

        algos, det, bench, tf32, env = self.saved
        torch.use_deterministic_algorithms(algos)
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.benchmark = bench
        torch.backends.cudnn.allow_tf32 = tf32
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env


def phase_ddp_nccl(card, train_lines, train_s_step):
    """cli/train --multihost as one NCCL rank (torchrun's variables, a free
    port) at train_dtu.yaml's widths. Exact (`_Exact`) at batch
    DDP_EXACT_SB, where the deterministic algorithms fit in memory, against
    the same run without --multihost (the same data order and draws: the
    generator of step s at world size 1): each of DDP_NCCL_STEPS steps'
    losses within 1e-4 relative. Then at batch 4 as the training phase ran
    (not exact): the first step's losses within 1e-5 relative of that
    phase's, s/step beside its, and the gradient all-reduce of the last
    step on one NCCL rank, timed against a step: under 2%."""
    import os

    import torch
    import torch.distributed as dist

    from diner_tpu_torch.cli import train as train_cli
    from diner_tpu_torch.parallel import all_reduce_grads_, init_multihost

    runs = {}
    env = _ddp_env(_free_port())
    saved = {k: os.environ.get(k) for k in env}

    def run(label, cfg, extra):
        if extra:
            os.environ.update(env)
            os.environ["MASTER_PORT"] = str(_free_port())
        _zero_launches()
        state = train_cli.main([str(cfg), "--run-dir", str(tmp / label),
                                "--max-steps", str(DDP_NCCL_STEPS),
                                "--log-every", "1", *extra])
        torch.cuda.synchronize()
        check(not dist.is_initialized(),
              "cli/train --multihost left its process group")
        runs[label] = (_launches(), [json.loads(x) for x in (
            tmp / label / "metrics.jsonl").read_text().splitlines()])
        return state

    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            exact = _train_config(tmp, DDP_EXACT_SB, "exact.yaml")
            with _Exact():
                run("exact_single", exact, [])
                run("exact_nccl", exact, ["--multihost"])
            state = run("nccl", _train_config(tmp, TRAIN_SB),
                        ["--multihost"])

        # the all-reduce alone: one NCCL rank again, the last step's grads
        os.environ["MASTER_PORT"] = str(_free_port())
        init_multihost(device="cuda")
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"ddp_nccl: backend {dist.get_backend()}")
        params = [p for g in state.optimizer.param_groups
                  for p in g["params"]]
        n_bytes = sum(p.grad.numel() * p.grad.element_size()
                      for p in params if p.grad is not None)
        times = []
        for _ in range(12):
            torch.cuda.synchronize()
            t = time.perf_counter()
            all_reduce_grads_(params)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        dist.destroy_process_group()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for label, (got, ls) in runs.items():
        check(got == _expect(k4=DDP_NCCL_STEPS, k4_backward=DDP_NCCL_STEPS),
              f"ddp_nccl: the {label} run launched {got}, expected one K4 "
              f"and one K4 backward a step")
        check([x["step"] for x in ls] == list(range(DDP_NCCL_STEPS)),
              f"ddp_nccl: the {label} run's metrics steps "
              f"{[x['step'] for x in ls]}")
    ref, lines = runs["exact_single"][1], runs["exact_nccl"][1]
    worst = max(_rel(x[k], y[k]) for x, y in zip(lines, ref)
                for k in LOSS_KEYS)
    check(worst <= 1e-4, f"ddp_nccl: exact losses {lines} against the "
                         f"single process's {ref}")
    first = max(_rel(runs["nccl"][1][0][k], train_lines[0][k])
                for k in LOSS_KEYS)
    check(first <= 1e-5, f"ddp_nccl: the first step's losses "
                         f"{runs['nccl'][1][0]} against the training "
                         f"phase's {train_lines[0]}")
    s_step = {label: [1.0 / x["steps_per_sec"] for x in ls]
              for label, (_, ls) in runs.items()}
    steady = statistics.median(s_step["nccl"][2:])
    reduce_s = statistics.median(times[2:])
    share = reduce_s / steady
    log(f"ddp_nccl: cli/train --multihost, one NCCL rank, {DDP_NCCL_STEPS} "
        f"steps at batch {DDP_EXACT_SB}, exact (deterministic algorithms, "
        f"cuDNN TF32 off): losses within {worst:.2e} relative of the same "
        f"run without --multihost; s/step "
        f"{[round(v, 4) for v in s_step['exact_nccl']]} against "
        f"{[round(v, 4) for v in s_step['exact_single']]} [{card}]")
    log(f"ddp_nccl: at batch {TRAIN_SB} (not exact): the first step's "
        f"losses within {first:.2e} relative of the training phase's; "
        f"s/step {[round(v, 4) for v in s_step['nccl']]}, after warm-up "
        f"{steady:.4f} against the training phase's {train_s_step:.4f} "
        f"[{card}]")
    log(f"ddp_nccl: gradient all-reduce on one NCCL rank "
        f"({n_bytes / 1e6:.1f} MB in 25 MiB buckets): {reduce_s * 1e3:.3f} "
        f"ms = {100 * share:.3f}% of a step at batch {TRAIN_SB}")
    check(share < 0.02, f"ddp_nccl: the all-reduce takes {100 * share:.2f}% "
                        f"of a step, not under 2%")
    return {n: sum(got[n] for got, _ in runs.values()) for n in _launches()}


def _global_draws(model, batch, step: int):
    """The draws of `step` for a global batch (on the CPU, from a seed):
    the patch pixels and the sampler noise (u_strat, g, u_fill)."""
    import torch

    gen = torch.Generator().manual_seed(1000 + step)
    SB, H, W, _ = batch["target_rgb"].shape
    pix = model._select_pixels(batch, SB, H, W, gen)
    cfg, n = model.render_cfg, model.n_rays
    noise = (torch.rand(SB, n, cfg.n_depth_candidates, generator=gen),
             torch.randn(SB, n, cfg.n_gaussian, generator=gen),
             torch.rand(SB, n, cfg.n_samples, generator=gen))
    return pix, noise


def _explicit_steps(cfg: Path, rows: slice, dev, save_last=None,
                    load_last=None, plant=False):
    """DDP_STEPS train steps of train_dtu.yaml's model (seed 0, broadcast
    from rank 0 in a group) on the global batches of scenes (0, 1), (2, 3),
    ... with the global draws of _global_draws; this process trains on
    `rows` of each. Just before the last step the reference writes its
    NeRF, Adam and schedule states to `save_last` and the ranks replace
    theirs by that file's (`load_last`), so that the last step starts from
    the same state everywhere. `plant` is the gate's own check: the last
    step's encoder gradient is rank 0's rows' alone (the mean over ranks
    everywhere else). Returns the losses, s/step, the parameters after the
    first and the last step, and the gradients' rms as Adam holds it."""
    import torch
    import torch.distributed as dist

    import diner_tpu_torch.train.step as step_mod

    from diner_tpu_torch.cli.build import (build_dataset, build_diner,
                                           optimizer_kwargs)
    from diner_tpu_torch.core.config import load_config
    from diner_tpu_torch.data import collate, to_device_batch
    from diner_tpu_torch.models.diner import to_tensors
    from diner_tpu_torch.parallel import broadcast_module_
    from diner_tpu_torch.train import create_train_state, train_step

    conf = load_config(cfg)
    train_set = build_dataset(conf["data"]["train"], stage="train")
    torch.manual_seed(0)
    model = build_diner(conf, znear=train_set.znear, zfar=train_set.zfar)
    model.to(dev)
    broadcast_module_(model)
    opt_kw = optimizer_kwargs(conf)
    state = create_train_state(model, opt_kw.pop("lr"), **opt_kw)
    losses, seconds, params = [], [], []
    real_all_reduce = step_mod.all_reduce_grads_

    def encoder_from_rank0(params_):
        params_ = list(params_)
        enc = {id(p) for p in model.nerf.encoder.parameters()}
        local = [(p, p.grad.clone()) for p in params_
                 if id(p) in enc and p.grad is not None]
        real_all_reduce(params_)
        for p, g in local:
            dist.broadcast(g, 0)
            p.grad.copy_(g)

    for step in range(DDP_STEPS):
        batch = to_tensors(to_device_batch(collate(
            [train_set[i] for i in (2 * step, 2 * step + 1)])), "cpu")
        pix, noise = _global_draws(model, batch, step)
        local = {k: v[rows].to(dev) for k, v in batch.items()}
        last = step == DDP_STEPS - 1
        if last and save_last is not None:
            torch.save({"nerf": model.nerf.state_dict(),
                        "optimizer": state.optimizer.state_dict(),
                        "scheduler": state.scheduler.state_dict()},
                       save_last)
        if last and load_last is not None:
            pre = torch.load(load_last, map_location="cpu",
                             weights_only=True)
            model.nerf.load_state_dict(pre["nerf"])
            state.optimizer.load_state_dict(pre["optimizer"])
            state.scheduler.load_state_dict(pre["scheduler"])
        step_mod.all_reduce_grads_ = (encoder_from_rank0 if last and plant
                                      else real_all_reduce)
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            losses.append(train_step(state, local, pix=pix[rows].to(dev),
                                     noise=tuple(x[rows].to(dev)
                                                 for x in noise)))
        finally:
            step_mod.all_reduce_grads_ = real_all_reduce
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        params.append({k: v.detach().to("cpu", copy=True)
                       for k, v in model.nerf.state_dict().items()})
    # the gradients' root mean square as Adam sees it, sqrt(v_hat), for
    # each parameter
    opt = state.optimizer
    beta2 = opt.param_groups[0]["betas"][1]
    rms = {}
    for name, p in model.nerf.named_parameters():
        st = opt.state[p]
        rms[name] = (st["exp_avg_sq"] / (1 - beta2 ** float(st["step"]))
                     ).sqrt().cpu()
    return {"losses": losses, "seconds": seconds, "grad_rms": rms,
            "params": [params[0], params[-1]]}


def phase_ddp_two_ranks(card, plant=False):
    """Two ranks share cuda:0 over gloo (CUDA tensors), batch 1 each, at
    train_dtu.yaml's widths, against one process at batch 2 run first on
    the same global batches and draws, all exact (`_Exact`): DDP_STEPS
    steps' global losses within 1e-4 relative; the parameters within 1e-6
    at 99.9% of the elements after the first step; the last step starts
    from the reference's own state before it (parameters, Adam's moments
    and the schedule, copied into both ranks), and after it every tensor,
    the encoder's and ResnetFC's, within 1e-6 at 99.9% of its elements and
    every parameter within 2 lr; then cli/train --multihost in the same
    group (--logdir: one run directory, rank 0's stamp, written by rank 0),
    and a resume for DDP_RESUME_STEPS step. `plant` runs the gate's own
    check: the ranks' last step takes the encoder's gradient from rank
    0's rows alone, which the gate must refuse."""
    import gc
    import os

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=DATA_DIR) as tmp:
        tmp = Path(tmp)
        cfg = _train_config(tmp, 1)
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        with _Exact():
            ref = _explicit_steps(cfg, slice(0, 2), torch.device("cuda"),
                                  save_last=tmp / "pre_last.pt")
        ref_launches = _launches()
        ref_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        check(ref_launches == _expect(k4=DDP_STEPS, k4_backward=DDP_STEPS),
              f"ddp_two_ranks: the reference launched {ref_launches}")
        gc.collect()
        torch.cuda.empty_cache()

        coordinator = f"127.0.0.1:{_free_port()}"
        cli_port = _free_port()
        t = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--ddp-rank",
             str(r), str(tmp), coordinator] + (["--plant"] if plant else []),
            env=dict(os.environ, **_ddp_env(cli_port, r, 2)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        try:
            logs = [p.communicate(timeout=DDP_CHILD_TIMEOUT)[0]
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        seconds = time.perf_counter() - t
        for r, (p, out) in enumerate(zip(procs, logs)):
            check(p.returncode == 0, f"ddp_two_ranks: rank {r} exited "
                                     f"{p.returncode}:\n{out[-4000:]}")
        outs = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                for r in range(2)]
        runs = sorted((tmp / "logs").iterdir())
        check(len(runs) == 1 and all(o["run"] == str(runs[0]) for o in outs),
              f"ddp_two_ranks: run directories {runs}, "
              f"{[o['run'] for o in outs]}")
        run = runs[0]
        ckpts = sorted(p.name for p in (run / "ckpts").iterdir())
        steps = [json.loads(x)["step"] for x in
                 (run / "metrics.jsonl").read_text().splitlines()]

    r0, r1 = outs
    per_step = [max(_rel(r0["losses"][s][k], ref["losses"][s][k])
                    for k in LOSS_KEYS) for s in range(DDP_STEPS)]
    worst = max(per_step)
    log(f"ddp_two_ranks: global losses against batch 2's, the largest "
        f"relative difference a step: {[f'{v:.2e}' for v in per_step]}")
    check(r1["losses"] == r0["losses"],
          "ddp_two_ranks: the ranks logged different losses")
    check(worst <= 1e-4, f"ddp_two_ranks: losses {r0['losses']} against "
                         f"batch 2's {ref['losses']}")
    lr = 1e-4
    names = list(ref["grad_rms"])
    rms = torch.cat([ref["grad_rms"][k].reshape(-1) for k in names])
    diffs = [{k: (p[k] - q[k]).abs().reshape(-1) for k in names}
             for p, q in zip(r0["params"], ref["params"])]
    flat = [torch.cat(list(d.values())) for d in diffs]
    close = float((flat[0] <= 1e-6).float().mean())
    worst_p = [float(d.max()) for d in flat]

    def share(d, part):
        return float(torch.cat([d[k] for k in names if k.startswith(part)])
                     .le(1e-6).float().mean())

    last_close = {k: float((d <= 1e-6).float().mean())
                  for k, d in diffs[1].items()}
    least = {part: min((k for k in last_close if k.startswith(part)),
                       key=last_close.get) for part in ("mlp.", "encoder.")}
    log(f"ddp_two_ranks: parameters within 1e-6 of batch 2's at "
        f"{close:.6f} of {flat[0].numel()} elements after step 1 (largest "
        f"difference {worst_p[0]:.3e}); after step {DDP_STEPS}, started "
        f"from the reference's state: ResnetFC's at "
        f"{share(diffs[1], 'mlp.'):.6f} (its least tensor {least['mlp.']} "
        f"at {last_close[least['mlp.']]:.6f}), the encoder's at "
        f"{share(diffs[1], 'encoder.'):.6f} (its least tensor "
        f"{least['encoder.']} at {last_close[least['encoder.']]:.6f}), "
        f"largest difference {worst_p[1]:.3e} where the gradient rms, "
        f"Adam's sqrt(v_hat), is {float(rms[flat[1].argmax()]):.3e}"
        + (" [planted: the encoder's last step on rank 0's rows]"
           if plant else ""))
    check(all(torch.equal(p[k], v) for p, q in zip(r1["params"],
                                                   r0["params"])
              for k, v in q.items()),
          "ddp_two_ranks: the ranks' parameters differ")
    # after the first step the parameters differ by the gradients' order of
    # sums alone, and so do they after the last, which starts from the
    # reference's own state: without that copy the earlier steps' drift
    # entered the encoder's last-step gradients (0.966 of its elements
    # within 1e-6 after 3 steps on the H100, against a planted last-step
    # fault's 0.995), so only ResnetFC's tensors could be gated
    check(close >= 0.999 and worst_p[0] <= 2 * lr,
          f"ddp_two_ranks: parameters within 1e-6 at {close:.6f} of the "
          f"elements after one step, largest difference {worst_p[0]:.3e}")
    for part, name in (("ResnetFC", least["mlp."]),
                       ("the encoder", least["encoder."])):
        check(last_close[name] >= 0.999 and worst_p[1] <= 2 * lr,
              f"ddp_two_ranks: {part}'s {name} within 1e-6 at "
              f"{last_close[name]:.6f} of its elements after step "
              f"{DDP_STEPS}, the parameters {worst_p[1]:.3e} apart (at "
              f"most 2 lr from the same state)")
    cli_steps = DDP_CLI_STEPS + DDP_RESUME_STEPS
    check(ckpts == [f"step_{DDP_CLI_STEPS:08d}.pt",
                    f"step_{cli_steps:08d}.pt"]
          and steps == list(range(DDP_CLI_STEPS)) + [DDP_CLI_STEPS],
          f"ddp_two_ranks: checkpoints {ckpts}, metrics steps {steps}")
    for r, o in enumerate(outs):
        check(o["launches_explicit"] == _expect(k4=DDP_STEPS,
                                                k4_backward=DDP_STEPS)
              and o["launches_cli"] == _expect(k4=cli_steps,
                                               k4_backward=cli_steps),
              f"ddp_two_ranks: rank {r} launched {o['launches_explicit']} "
              f"and {o['launches_cli']}")
    log(f"ddp_two_ranks: the reference, one process at batch 2: s/step "
        f"{[round(v, 4) for v in ref['seconds']]}, peak memory "
        f"{ref_peak:.2f} GiB [{card}]")
    log(f"ddp_two_ranks: 2 ranks (gloo, CUDA tensors) at batch 1: global "
        f"losses within {worst:.2e} relative of batch 2's over {DDP_STEPS} "
        f"steps; the ranks' parameters bitwise equal")
    for r, o in enumerate(outs):
        log(f"ddp_two_ranks: rank {r}: s/step "
            f"{[round(v, 4) for v in o['seconds']]} (two processes sharing "
            f"one card over gloo: not a scaling number), peak memory "
            f"{o['peak'] / 2 ** 30:.2f} GiB, K4 and backward launches "
            f"{o['launches_explicit']['composite_rays']} + "
            f"{o['launches_cli']['composite_rays']} and "
            f"{o['launches_explicit']['composite_rays_backward']} + "
            f"{o['launches_cli']['composite_rays_backward']} "
            f"(explicit draws + cli/train)")
    log(f"ddp_two_ranks: cli/train --multihost --logdir: one run directory "
        f"{run.name}, rank 0's checkpoints {ckpts} and metrics steps "
        f"{steps} after a 2-rank --resume for {DDP_RESUME_STEPS} step; both "
        f"ranks done in {seconds:.1f} s with start-up [{card}]")
    return {n: sum(o["launches_explicit"][n] + o["launches_cli"][n]
                   for o in outs) for n in r0["launches_cli"]}


def ddp_rank_child(r: int, tmp: Path, coordinator: str,
                   plant: bool = False) -> int:
    """Rank r of phase_ddp_two_ranks, in its own process on cuda:0."""
    import torch
    import torch.distributed as dist

    from diner_tpu_torch.cli import train as train_cli
    from diner_tpu_torch.parallel import init_multihost

    _Exact().__enter__()   # as the reference
    dev = init_multihost(coordinator, 2, r, device="cuda", backend="gloo")
    check(dev == torch.device("cuda", 0) and dist.get_backend() == "gloo",
          f"rank {r} on {dev} over {dist.get_backend()}")
    cfg = tmp / "train.yaml"
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    out = _explicit_steps(cfg, slice(r, r + 1), dev,
                          load_last=tmp / "pre_last.pt", plant=plant)
    out["launches_explicit"] = _launches()
    _zero_launches()
    # cli/train in this group (--multihost keeps a group it finds)
    train_cli.main([str(cfg), "--logdir", str(tmp / "logs"), "--multihost",
                    "--max-steps", str(DDP_CLI_STEPS), "--log-every", "1"])
    runs = sorted((tmp / "logs").iterdir())
    check(len(runs) == 1, f"rank {r}: run directories {runs}")
    train_cli.main([str(cfg), "--run-dir", str(runs[0]), "--multihost",
                    "--resume", "--max-steps",
                    str(DDP_CLI_STEPS + DDP_RESUME_STEPS), "--log-every",
                    "1"])
    torch.cuda.synchronize()
    out["launches_cli"] = _launches()
    out["peak"] = torch.cuda.max_memory_allocated()
    out["run"] = str(runs[0])
    torch.save(out, tmp / f"rank{r}.pt")
    dist.destroy_process_group()
    return 0


def write_lpips_npz(path: Path, seed: int = 0):
    """Random LPIPS weights from `seed` in the JAX package's
    save_lpips_npz layout (flax keys, HWIO kernels), as
    scripts/port_lpips.py writes real ones."""
    import numpy as np

    from diner_tpu_torch.nn.lpips import LIN_CH, VGG16_STAGES

    rng = np.random.RandomState(seed)
    arrays, c_in = {}, 3
    for si, (ch, reps) in enumerate(VGG16_STAGES):
        for ci in range(reps):
            w = rng.randn(ch, c_in, 3, 3) * np.sqrt(2.0 / (9 * c_in))
            name = f"params/net/conv{si + 1}_{ci + 1}"
            arrays[f"{name}/kernel"] = w.transpose(2, 3, 1, 0).astype(
                np.float32)
            arrays[f"{name}/bias"] = (rng.randn(ch) * 0.01).astype(
                np.float32)
            c_in = ch
    for i, ch in enumerate(LIN_CH):
        arrays[f"params/lin{i}"] = (rng.rand(ch) + 0.01).astype(np.float32)
    np.savez(path, **arrays)


def phase_lpips(eval_dir: Path, dtu_root: Path, card):
    """LPIPS on the card: cli/eval_folder score --lpips on the eval phase's
    folder, render_eval --lpips of the fast DTU preset on the DTU tree;
    each image's card LPIPS within LPIPS_TOL of the CPU's on the same PNGs
    (cuDNN's TF32 is off inside make_lpips_fn); seconds per image."""
    import numpy as np

    from diner_tpu_torch.cli import eval_folder
    from diner_tpu_torch.data.dtu import DTUDataset
    from diner_tpu_torch.image_ops.png import read_png
    from diner_tpu_torch.nn.lpips import load_lpips_npz, make_lpips_fn

    hw = (int(512 * DTU_DOWNSAMPLE), int(640 * DTU_DOWNSAMPLE))
    with tempfile.TemporaryDirectory(dir=DATA_DIR) as tmp:
        tmp = Path(tmp)
        npz = tmp / "lpips_vgg.npz"
        write_lpips_npz(npz)
        t = time.perf_counter()
        check(eval_folder.main(["score", str(eval_dir), "--lpips",
                                str(npz)]) == 0, "eval_folder score failed")
        score_s = time.perf_counter() - t
        scores = _eval_preset("lpips_dtu_eval", DTU_PRESET,
                              _dtu_data(dtu_root), DTUDataset, 2, hw, card,
                              tmp, extra=["--lpips", str(npz)])
        check("lpips" in scores, f"render_eval --lpips scores {scores}")
        rows = [r for d in (eval_dir, tmp / "lpips_dtu_eval_out")
                for r in json.loads((d / "detailed_report.json")
                                    .read_text())]
        weights = load_lpips_npz(npz)
        on_card = make_lpips_fn(weights, device="cuda")
        on_cpu = make_lpips_fn(weights, device="cpu")
        pairs = []
        for row in rows:
            pred_p = Path(row["path"])
            gt_p = pred_p.with_name(pred_p.name.replace("-pred.png",
                                                        "-gt.png"))
            pairs.append(tuple(read_png(p).astype(np.float32)[..., :3] / 255
                               for p in (pred_p, gt_p)))
        on_card(*pairs[0])   # warm-up
        card_s, errs = [], []
        for row, (pred, gt) in zip(rows, pairs):
            t = time.perf_counter()
            value = on_card(pred, gt)
            card_s.append(time.perf_counter() - t)
            errs.append(max(abs(value - row["lpips"]),
                            abs(row["lpips"] - on_cpu(pred, gt))))
    check(max(errs) <= LPIPS_TOL,
          f"lpips: the card's per-image LPIPS differ from the CPU's by up to "
          f"{max(errs):.2e}")
    log(f"lpips: eval_folder score --lpips on {len(rows) - 2} images in "
        f"{score_s:.3f} s, render_eval --lpips on 2 DTU images ({hw[0]}x"
        f"{hw[1]}): lpips {[round(r['lpips'], 6) for r in rows]}; card vs "
        f"CPU within {max(errs):.2e} (tolerance {LPIPS_TOL:.0e}, cuDNN TF32 "
        f"off); LPIPS alone {statistics.median(card_s) * 1e3:.2f} ms per "
        f"image on the card [{card}]")


def _launches():
    from diner_tpu_torch.kernels import KERNELS

    return {n: k.launches for n, k in KERNELS.items()}


def _zero_launches():
    from diner_tpu_torch.kernels import KERNELS

    for k in KERNELS.values():
        k.launches = 0


def _expect(k1=0, k2=0, k4=0, k4_backward=0):
    return {"likelihood_from_anchors": k1, "remap_anchors": k2,
            "likelihood_from_chord": 0, "composite_rays": k4,
            "composite_rays_backward": k4_backward}


class _TimedReads:
    """Times every __getitem__ of a dataset class while active: the
    reader's host seconds, apart from what the caller does with them."""

    def __init__(self, cls):
        self.cls, self.seconds = cls, []

    def __enter__(self):
        orig = self.orig = self.cls.__getitem__

        def timed(ds, idx):
            t = time.perf_counter()
            try:
                return orig(ds, idx)
            finally:
                self.seconds.append(time.perf_counter() - t)

        self.cls.__getitem__ = timed
        return self

    def __exit__(self, *exc):
        self.cls.__getitem__ = self.orig

    def per_sample(self):
        return statistics.fmean(self.seconds) if self.seconds else 0.0


def _sphere_views(H_, W_, scale, exts, K):
    """The port's synthetic sphere scene (seed 0), scaled by `scale`, seen
    by world->cam `exts` through K at H_ x W_: [(rgb, alpha, depth)]."""
    from diner_tpu_torch.data import SyntheticSphereDataset

    ds = SyntheticSphereDataset(n_scenes=1, H=H_, W=W_, seed=0)
    centers, radii, colors = ds._scene(0)
    return [ds._render_view(e, K, centers * scale, radii * scale, colors)
            for e in exts]


def _lookat(eye, up):
    """World->cam extrinsics at `eye` looking at the origin."""
    from diner_tpu_torch.data.synthetic import _lookat

    return _lookat(eye, up=up)


def _u8(img01):
    import numpy as np

    return (np.clip(img01, 0, 1) * 255).astype(np.uint8)


def write_png16_adaptive(path, img):
    """A uint16 grey PNG by Pillow's encoder, which, as libpng-based writers
    do, picks each row's filter by trying them (mostly Paeth on a depth
    map), so the readers decode what real depth trees hold."""
    import numpy as np
    from PIL import Image

    Image.fromarray(np.asarray(img, np.uint16)).save(path)


def row_filters(path):
    """{filter type: rows} of a PNG."""
    import collections
    import struct
    import zlib

    data, pos, idat = Path(path).read_bytes(), 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            (H,) = struct.unpack(">I", body[4:8])
        elif kind == b"IDAT":
            idat.append(body)
    rows = zlib.decompress(b"".join(idat))
    stride = len(rows) // H
    return dict(sorted(collections.Counter(
        rows[y * stride] for y in range(H)).items()))


def _dtu_grid():
    """World->cam extrinsics of the DTU tree's 7 x 7 grid of cams at
    DTU_CAM_RADIUS about the sphere scene (scaled units)."""
    import numpy as np

    return [_lookat(DTU_CAM_RADIUS * np.array([
        np.sin(az) * np.cos(el), np.sin(el), -np.cos(az) * np.cos(el)]),
        np.array([0.0, -1.0, 0.0]))
        for el in np.linspace(-0.25, 0.25, 7)
        for az in np.linspace(-0.5, 0.5, 7)]


def write_dtu_tree(root: Path, card):
    """A DTU-layout tree of one scan at the dataset's real size: 49 MVSNet
    cam files (intrinsics at 1/4 resolution, translations in mm), the
    512x640 rectified image of every cam under each of the 7 lights, and
    the uint16 TransMVSNet depth and confidence PNGs of the source cams
    30, 10, 6 and 35. The images and depths are the synthetic sphere scene
    seen from a 7 x 7 grid of cams at DTU_CAM_RADIUS, its depths inside
    the reader's [znear, zfar] = [400, 1500] x 0.7/872."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    from diner_tpu_torch.data.codecs import read_png16, write_mvsnet_cam
    from diner_tpu_torch.data.dtu import DTUDataset

    t = time.perf_counter()
    sf = DTUDataset.SCALE_FACTOR_DEFAULT
    K = np.array([[0.9 * 640, 0, 320], [0, 0.9 * 640, 256], [0, 0, 1]],
                 np.float32)
    exts = _dtu_grid()
    views = _sphere_views(512, 640, DTU_SCENE_SCALE, exts, K)
    cams = root / "Cameras" / "train"
    cams.mkdir(parents=True)
    quarter = K.copy()
    quarter[:2] /= 4
    for i, e in enumerate(exts):
        mm = e.copy()
        mm[:3, 3] /= sf
        write_mvsnet_cam(cams / f"{i:08d}_cam.txt", mm, quarter, 425.0, 2.5)
    images = root / "Rectified" / "scan1_train"
    images.mkdir(parents=True)
    jobs = [(images / f"rect_{i + 1:03d}_{light}_r5000.png",
             _u8(rgb * (0.7 + 0.05 * light)))
            for i, (rgb, _, _) in enumerate(views) for light in range(7)]
    with ThreadPoolExecutor(8) as pool:   # Pillow's encoder frees the GIL
        list(pool.map(lambda j: Image.fromarray(j[1]).save(j[0]), jobs))
    depths = root / "Depths" / "scan1"
    depths.mkdir(parents=True)
    lo, hi = [], []
    for i in DTUDataset.SRC_CAM_IDCS:
        d = views[i][2][..., 0]
        lo.append(d[d > 0].min())
        hi.append(d.max())
        stem = depths / f"depth_map_{i:04d}_TransMVSNet"
        # the reader undoes the TransMVSNet training scale: a PNG unit is
        # 1e-4 of the reader's (scaled) depth
        write_png16_adaptive(stem.with_suffix(".png"), np.round(d / 1e-4))
        conf = np.where(d > 0, 0.9 - 0.3 * (d - d.min()) / np.ptp(d), 0)
        write_png16_adaptive(stem.with_name(stem.name + "_conf.png"),
                             np.round(conf / 1e-4))
    (root / "splits").mkdir()
    for split in ("train", "val"):
        (root / "splits" / f"dtu_{split}_all.txt").write_text("scan1\n")
    check(min(lo) > 400 * sf and max(hi) < 1500 * sf,
          f"source depths {min(lo)}..{max(hi)} outside [znear, zfar]")
    log(f"dtu tree: 49 cams, {len(jobs)} 512x640 images, "
        f"{2 * len(DTUDataset.SRC_CAM_IDCS)} uint16 depth and conf PNGs, "
        f"source depths {min(lo):.4f}..{max(hi):.4f}, written in "
        f"{time.perf_counter() - t:.2f} s")
    # one depth map: its rows' filters and the port's decode of it
    i = DTUDataset.SRC_CAM_IDCS[0]
    path = depths / f"depth_map_{i:04d}_TransMVSNet.png"
    filters = row_filters(path)
    check(np.array_equal(read_png16(path),
                         np.round(views[i][2][..., 0] / 1e-4)),
          f"{path.name} does not read back as written")
    check(filters.get(3, 0) + filters.get(4, 0) > 0,
          f"{path.name}: no Average or Paeth rows ({filters})")
    seconds = []
    for _ in range(20):
        t = time.perf_counter()
        read_png16(path)
        seconds.append(time.perf_counter() - t)
    log(f"dtu tree: a 512x640 uint16 depth PNG with row filters {filters} "
        f"(type: rows; 3 Average, 4 Paeth) decodes in "
        f"{statistics.median(seconds) * 1e3:.3f} ms (median of 20, one "
        f"thread) [{card}]")


def _dtu_data(root: Path):
    return {"module": "DTUDataset", "kwargs": {
        "root": str(root), "depth_fname": "TransMVSNet",
        "split_dir": str(root / "splits"), "downsample": DTU_DOWNSAMPLE}}


def _random_ckpt(conf, tmp: Path) -> Path:
    """The preset's NeRF with random weights from seed 0, saved as the
    port's trainer saves a checkpoint."""
    import torch

    from diner_tpu_torch.cli.build import build_nerf
    from diner_tpu_torch.train import ckpt_io

    torch.manual_seed(0)
    ckpt_io.save(tmp / "ckpts", 0, {
        "nerf": build_nerf(conf["nerf"]).state_dict(), "step": 0})
    return tmp / "ckpts"


def _eval_preset(label, preset, data, dataset_cls, n, hw, card, tmp: Path,
                 extra=()):
    """cli/render_eval of `preset` with its data section replaced by
    `data`, from a random checkpoint, on `n` images of `hw` pixels; each
    image must launch K1, K2 and K4 once a chunk of the preset. Returns the
    scores."""
    import numpy as np
    import yaml

    from diner_tpu_torch.cli import render_eval
    from diner_tpu_torch.core.config import load_config

    conf = load_config(preset)
    conf["data"]["val"]["dataset"] = data
    per_image = -(-hw[0] * hw[1]
                  // conf["renderer"]["kwargs"]["eval_chunk_rays"])
    cfg = tmp / f"{label}.yaml"
    cfg.write_text(yaml.safe_dump(conf))
    ckpt = _random_ckpt(conf, tmp)
    out = tmp / f"{label}_out"
    _zero_launches()
    t = time.perf_counter()
    with _TimedReads(dataset_cls) as reads:
        scores = render_eval.main(["--config", str(cfg), "--ckpt", str(ckpt),
                                   "--out", str(out), "--n", str(n),
                                   *extra])
    seconds = time.perf_counter() - t
    launches = _launches()
    pngs = sorted(p.name for p in (out / "visualizations").iterdir())
    log(f"{label}: render_eval --n {n}: {len(pngs)} PNGs, scores {scores}; "
        f"reader {reads.per_sample():.4f} s per sample, the rest "
        f"{(seconds - sum(reads.seconds)) / n:.4f} s per image (render, "
        f"PNGs, scores), {seconds:.3f} s in all [{card}]; launches "
        f"{launches}")
    check(launches == _expect(n * per_image, n * per_image, n * per_image),
          f"{label}: launches {launches}, expected {per_image} of K1, K2 and "
          f"K4 per image")
    check(len(pngs) == 4 * n and all(np.isfinite(v) for v in scores.values()),
          f"{label}: wrote {pngs}, scores {scores}")
    return scores


def phase_dtu_eval(root: Path, card):
    """render_eval of the fast DTU preset on the DTU tree, then the reader
    alone on four samples."""
    from diner_tpu_torch.data.dtu import DTUDataset

    hw = (int(512 * DTU_DOWNSAMPLE), int(640 * DTU_DOWNSAMPLE))
    with tempfile.TemporaryDirectory(dir=DATA_DIR) as tmp:
        _eval_preset("dtu_eval", DTU_PRESET, _dtu_data(root), DTUDataset, 2,
                     hw, card, Path(tmp))
    ds = DTUDataset(root, stage="val", split_dir=root / "splits",
                    downsample=DTU_DOWNSAMPLE)
    idcs = (1, 60, 200, 342)
    t = time.perf_counter()
    samples = [ds[i] for i in idcs]
    seconds = (time.perf_counter() - t) / len(idcs)
    h, w = samples[0]["target_rgb"].shape[:2]
    log(f"dtu_eval: the reader alone, one thread: {seconds:.4f} s per sample"
        f" at downsample {DTU_DOWNSAMPLE} ({h}x{w}; 5 RGB PNGs and 8 uint16 "
        f"PNGs at 512x640) [{card}]")


def write_facescape_tree(root: Path):
    """One FaceScape subject ("001", expression 01) at 256x256: 13 x 5
    cams on a sphere of radius 1.6 m about the head (-y is frontal, z up),
    each with its RGBA image, uint16 TransMVSNet depth and confidence PNGs
    and cameras.json."""
    import numpy as np

    from diner_tpu_torch.image_ops.png import write_png

    H_, W_ = FACESCAPE_HW
    K = np.array([[1.1 * W_, 0, W_ / 2], [0, 1.1 * W_, H_ / 2], [0, 0, 1]],
                 np.float32)
    exts = [_lookat(1.6 * np.array([np.sin(az) * np.cos(el),
                                    -np.cos(az) * np.cos(el), np.sin(el)]),
                    np.array([0.0, 0.0, -1.0]))
            for el in np.radians(np.linspace(-40, 40, 5))
            for az in np.radians(np.linspace(-90, 90, 13))]
    scan = root / "001" / "01"
    cams = {}
    for i, (e, (rgb, alpha, depth)) in enumerate(zip(exts, _sphere_views(
            H_, W_, 0.5, exts, K))):
        cams[str(i)] = {"extrinsics": e[:3].tolist(),
                        "intrinsics": K.tolist()}
        view = scan / f"view_{i:05d}"
        view.mkdir(parents=True)
        write_png(view / "rgba_colorcalib.png",
                  _u8(np.concatenate([rgb, alpha], -1)))
        d = depth[..., 0]
        write_png16_adaptive(view / "depth_TransMVSNet.png",
                             np.round(d / 1e-4))
        write_png16_adaptive(view / "depth_TransMVSNet_conf.png",
                             np.round(np.where(d > 0, 0.9, 0) / 1e-4))
    (scan / "cameras.json").write_text(json.dumps(cams))


def phase_facescape_eval(card):
    from diner_tpu_torch.data.facescape import FacescapeDataset

    with tempfile.TemporaryDirectory(dir=DATA_DIR) as tmp:
        tmp = Path(tmp)
        write_facescape_tree(tmp / "facescape")
        data = {"module": "FacescapeDataset", "kwargs": {
            "root": str(tmp / "facescape"), "meta_dir": str(tmp / "meta"),
            "val_subjects": ["001"]}}
        _eval_preset("facescape_eval", FACESCAPE_PRESET, data,
                     FacescapeDataset, 1, FACESCAPE_HW, card, tmp)


def write_multiface_tree(root: Path, meta_dir: Path):
    """One MultiFace subject, sequence and frame at the raw 2048x1334
    (H x W): a KRT rig of 5 cams at 1 m (mm units), the 4 corner ones the
    split's reference cams and the centre one the target; RGB frames,
    masks, and uint16 depths at the 256x160 the reader aligns to.
    Returns the split config."""
    import numpy as np
    from PIL import Image

    from diner_tpu_torch.data.codecs import nearest_resize

    H_, W_ = MULTIFACE_RAW
    K = np.array([[1300.0, 0, W_ / 2], [0, 1300.0, H_ / 2], [0, 0, 1]],
                 np.float32)
    angles = [(-0.4, -0.25), (0.4, -0.25), (0.4, 0.25), (-0.4, 0.25),
              (0.0, 0.0)]   # the reference cams in order round, the target
    exts = [_lookat(np.array([np.sin(az) * np.cos(el), np.sin(el),
                              -np.cos(az) * np.cos(el)]),
                    np.array([0.0, -1.0, 0.0])) for az, el in angles]
    subj, seq, names = "m--20180227--0000--0000000--GHS", "E001_Neutral", [
        f"40010{i}" for i in range(len(exts))]
    krt = []
    for name, e in zip(names, exts):
        rt = e[:3].astype(np.float64)
        rt[:, 3] *= 1000.0
        krt += [name, *(" ".join(str(v) for v in r) for r in K),
                "0 0 0 0 0", *(" ".join(str(v) for v in r) for r in rt), ""]
    (root / subj).mkdir(parents=True)
    (root / subj / "KRT").write_text("\n".join(krt) + "\n")
    h, w = (H_ // 8) // 32 * 32, (W_ // 8) // 32 * 32
    for name, (rgb, alpha, depth) in zip(names, _sphere_views(
            H_, W_, 0.35, exts, K)):
        for kind, img in (("images", _u8(rgb)), ("masks", _u8(alpha[..., 0]))):
            (root / subj / kind / seq / name).mkdir(parents=True)
            Image.fromarray(img).save(root / subj / kind / seq / name
                                      / "000001.png")
        (root / subj / "depths" / seq / name).mkdir(parents=True)
        write_png16_adaptive(
            root / subj / "depths" / seq / name / "000001.png",
            np.round(nearest_resize(depth[..., 0], h, w) / 1e-4))
    centers = [(-e[:3, :3].T @ e[:3, 3] * 1000.0).tolist() for e in exts[:4]]
    split = {"val": {"subjects": [subj], "sequences": [seq],
                     "ref_centers": centers},
             "train": {"subjects": [], "sequences": [], "ref_centers": []}}
    meta_dir.mkdir(parents=True)
    (meta_dir / "split.json").write_text(json.dumps(split))
    return meta_dir / "split.json"


def phase_multiface_eval(card):
    from diner_tpu_torch.data.multiface import MultiFaceDataset

    h = (MULTIFACE_RAW[0] // 8) // 32 * 32
    w = (MULTIFACE_RAW[1] // 8) // 32 * 32
    with tempfile.TemporaryDirectory(dir=DATA_DIR) as tmp:
        tmp = Path(tmp)
        split = write_multiface_tree(tmp / "multiface", tmp / "meta")
        data = {"module": "MultiFaceDataset", "kwargs": {
            "root": str(tmp / "multiface"), "downsample": 8,
            "split_config": str(split), "meta_dir": str(tmp / "meta")}}
        ds = MultiFaceDataset(**data["kwargs"])
        check(len(ds) == 1 and ds[0]["target_rgb"].shape == (h, w, 3),
              f"multiface: {len(ds)} metas, expected the centre cam alone")
        log(f"multiface_eval: raw frames {MULTIFACE_RAW[0]}x"
            f"{MULTIFACE_RAW[1]}, downsample 8 aligned to {h}x{w}")
        _eval_preset("multiface_eval", MULTIFACE_PRESET, data,
                     MultiFaceDataset, 1, (h, w), card, tmp)


def phase_sweep(root: Path, card):
    """create_cam_sweep of the random fast-DTU model on the DTU val set: one
    sweep of SWEEP_FRAMES frames, K1, K2 and K4 20 times a frame."""
    import torch

    from diner_tpu_torch.cli.build import build_diner
    from diner_tpu_torch.core.config import load_config
    from diner_tpu_torch.data.dtu import DTUDataset
    from diner_tpu_torch.eval.sweep import create_cam_sweep

    conf = load_config(DTU_PRESET)
    ds = DTUDataset(root, stage="val", split_dir=root / "splits",
                    downsample=DTU_DOWNSAMPLE)
    torch.manual_seed(0)
    model = build_diner(conf, ds.znear, ds.zfar)

    def render(batch, target_ext, seed):
        rgb, depth = model.render_batch(batch, target_extrinsics=target_ext,
                                        seed=seed, device="cuda")
        return rgb.cpu().numpy(), depth.cpu().numpy()

    H_, W_ = int(512 * DTU_DOWNSAMPLE), int(640 * DTU_DOWNSAMPLE)
    per_frame = -(-H_ * W_ // model.render_cfg.eval_chunk_rays)
    with tempfile.TemporaryDirectory(dir=DATA_DIR) as tmp:
        _zero_launches()
        t = time.perf_counter()
        create_cam_sweep(render, ds, Path(tmp), nframes=SWEEP_FRAMES,
                         n_cam_sweeps=1, fps=5)
        seconds = time.perf_counter() - t
        launches = _launches()
        written = sorted(p.name for p in Path(tmp).iterdir())
        log(f"sweep: {SWEEP_FRAMES} frames at {H_}x{W_} in {seconds:.3f} s "
            f"with set-up; wrote {written} [{card}]; launches {launches}")
    n = SWEEP_FRAMES * per_frame
    check(launches == _expect(n, n, n),
          f"sweep: launches {launches}, expected {per_frame} of K1, K2 and K4"
          f" a frame")
    check(written == ["scan1-0-ref_imgs.jpg", "scan1-0.mp4"],
          f"sweep wrote {written}")


def phase_dtu_train(root: Path, card):
    """cli/train at train_dtu.yaml's widths from the DTU tree (343 metas),
    batch 4, DTU_TRAIN_STEPS steps."""
    import numpy as np
    import torch
    import yaml

    from diner_tpu_torch.cli import train as train_cli
    from diner_tpu_torch.core.config import load_config
    from diner_tpu_torch.data.dtu import DTUDataset

    conf = load_config(TRAIN_CONFIG)
    for split in ("train", "val"):
        conf["data"][split]["dataset"] = _dtu_data(root)
    conf["data"]["train"]["dataloader"]["kwargs"]["batch_size"] = TRAIN_SB
    conf["trainer"] = {"kwargs": {"max_steps": DTU_TRAIN_STEPS,
                                  "val_check_interval": None}}
    with tempfile.TemporaryDirectory(dir=DATA_DIR) as tmp:
        tmp = Path(tmp)
        cfg = tmp / "train.yaml"
        cfg.write_text(yaml.safe_dump(conf))
        _zero_launches()
        t = time.perf_counter()
        with _TimedReads(DTUDataset) as reads:
            train_cli.main([str(cfg), "--run-dir", str(tmp / "run"),
                            "--log-every", "1"])
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        lines = [json.loads(x) for x in
                 (tmp / "run" / "metrics.jsonl").read_text().splitlines()]
    launches = _launches()
    check(launches == _expect(k4=DTU_TRAIN_STEPS,
                              k4_backward=DTU_TRAIN_STEPS),
          f"dtu_train: launches {launches}, expected one K4 and one K4 "
          f"backward a step")
    check([x["step"] for x in lines] == list(range(DTU_TRAIN_STEPS))
          and all(np.isfinite(v) for x in lines for v in x.values())
          and all(x["skipped_nonfinite"] == 0.0 for x in lines),
          f"dtu_train metrics {lines}")
    s_step = [round(1.0 / x["steps_per_sec"], 4) for x in lines]
    log(f"dtu_train: {DTU_TRAIN_STEPS} steps at batch {TRAIN_SB} from 343 "
        f"DTU metas in {seconds:.2f} s with set-up; s/step {s_step}; totals "
        f"{[round(x['total'], 5) for x in lines]}; the loader's reads "
        f"{len(reads.seconds)} samples at {reads.per_sample():.4f} s each "
        f"(4 threads) [{card}]; launches {launches}")


def _mvs_profile(net, batch, card, label="mvs profile: one sample",
                 step=None):
    """One cascade under torch.profiler, or `step()` (a training step)
    when given: the top MVS_TOP_OPS aten ops by their own device time, and
    the device's busy share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        if step is not None:
            step()
        else:
            with torch.inference_mode():
                net(*batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    ops = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::")
                  and e.self_device_time_total > 0),
                 key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA) / 1e3
    op_ms = sum(e.self_device_time_total for e in ops) / 1e3
    check(ops, "mvs profile: torch.profiler saw no device time")
    log(f"{label}, {wall_ms:.2f} ms wall, device busy "
        f"{busy_ms:.2f} ms ({busy_ms / wall_ms:.1%}), aten ops' own device "
        f"time {op_ms:.2f} ms [{card}]; top {MVS_TOP_OPS} ops by device "
        f"time:")
    for e in ops[:MVS_TOP_OPS]:
        ms = e.self_device_time_total / 1e3
        log(f"  {e.key:<36} {ms:9.3f} ms {ms / op_ms:6.1%} {e.count:6d} calls")


def _mvs_card_vs_cpu(net, sample, card):
    """The cascade on the card (TF32 off) against the CPU on one sample,
    stage by stage. Where a stage's hypotheses agree (an earlier stage may
    have picked another hypothesis at a near-tie and moved them), the
    confidence must agree within 1e-4 and the same hypothesis must win
    wherever the CPU's two largest probabilities differ by more than 1e-5.
    Returns the share of pixels whose final depth differs."""
    import copy

    import torch

    from diner_tpu_torch.cli import mvs as mvs_cli

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            gpu = net(*mvs_cli.batch_of(sample, torch.device("cuda")))
            cpu_net = copy.deepcopy(net).cpu()
            t = time.perf_counter()
            cpu = cpu_net(*mvs_cli.batch_of(sample, torch.device("cpu")))
            cpu_s = time.perf_counter() - t
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    report = []
    for st in ("stage1", "stage2", "stage3"):
        g = {k: v.cpu() for k, v in gpu[st].items()}
        c = cpu[st]
        hyp = ((g["depth_values"] - c["depth_values"]).abs()
               <= 1e-6 * c["depth_values"].abs()).all(dim=1)
        top2 = c["prob_volume"].topk(2, dim=1).values
        clear = hyp & (top2[:, 0] - top2[:, 1] > 1e-5)
        conf_err = float((g["photometric_confidence"]
                          - c["photometric_confidence"]).abs()[hyp].max())
        wrong = int((g["prob_volume"].argmax(1)
                     != c["prob_volume"].argmax(1))[clear].sum())
        agree = float(hyp.float().mean())
        report.append(f"{st}: hypotheses agree at {agree:.6f}, max |conf| "
                      f"diff {conf_err:.2e}, other winners at {wrong} of "
                      f"{int(clear.sum())} clear pixels")
        check(agree > 0.99 and conf_err <= 1e-4
              and wrong == 0, f"mvs card vs cpu: {report[-1]}")
    d_g, d_c = gpu["depth"].cpu(), cpu["depth"]
    differs = float(((d_g - d_c).abs() > 1e-6 * d_c.abs()).float().mean())
    log(f"mvs card vs cpu (TF32 off, one 512x640 sample; the CPU took "
        f"{cpu_s:.2f} s): {'; '.join(report)}; final depth differs at "
        f"{differs:.6f} of the pixels [{card}]")
    return differs


def _mvs_reach(args, dv):
    """The depths the cascade can output from full-range hypotheses dv:
    stages 2 and 3 sweep +-ndepth/2 of their intervals about the depth
    before, so they reach past dv's ends."""
    nd = [int(x) for x in args.ndepths.split(",")]
    ratio = [float(x) for x in args.depth_inter_r.split(",")]
    step = (dv[-1] - dv[0]) / len(dv)
    out = sum(n / 2 * r * step for n, r in zip(nd[1:], ratio[1:]))
    return dv[0] - out, dv[-1] + out


def write_mvs_eval_scan(root: Path):
    """The sphere scene in the MVSNet eval layout at MVS_EVAL_HW: 5 cams of
    the DTU grid (the centre and its 4 neighbours; full-resolution K, mm),
    their PNG images and a pair.txt in which every view is a reference
    with the other 4 as sources."""
    import numpy as np
    from PIL import Image

    from diner_tpu_torch.data.codecs import write_mvsnet_cam
    from diner_tpu_torch.data.dtu import DTUDataset

    H_, W_ = MVS_EVAL_HW
    K = np.array([[0.9 * W_, 0, W_ / 2], [0, 0.9 * W_, H_ / 2], [0, 0, 1]],
                 np.float32)
    grid = _dtu_grid()
    exts = [grid[i] for i in (24, 23, 25, 17, 31)]
    views = _sphere_views(H_, W_, DTU_SCENE_SCALE, exts, K)
    (root / "images").mkdir(parents=True)
    (root / "cams").mkdir()
    for v, (e, (rgb, _, _)) in enumerate(zip(exts, views)):
        Image.fromarray(_u8(rgb)).save(root / "images" / f"{v:08d}.png")
        mm = e.copy()
        mm[:3, 3] /= DTUDataset.SCALE_FACTOR_DEFAULT
        write_mvsnet_cam(root / "cams" / f"{v:08d}_cam.txt", mm, K, 425.0,
                         2.5)
    lines = [str(len(exts))]
    for ref in range(len(exts)):
        srcs = [s for s in range(len(exts)) if s != ref]
        lines += [str(ref), f"{len(srcs)} " + " ".join(f"{s} 100.0"
                                                       for s in srcs)]
    (root / "pair.txt").write_text("\n".join(lines) + "\n")


def phase_mvs(root: Path, card, eval_root: Path):
    """cli/mvs write at full width on the DTU tree (4 samples: the corner
    cams 30, 10, 6 and 35 at light 3), its 12 PNGs checked; one sample's
    profile; render_eval of the fast DTU preset from the priors just
    written; the card against the CPU on one sample; cli/mvs eval at
    MVS_EVAL_HW with 5 views. The MVS path launches none of K1-K4."""
    import numpy as np
    import torch

    from diner_tpu_torch.cli import mvs as mvs_cli
    from diner_tpu_torch.data import dtu as dtu_reader
    from diner_tpu_torch.data.codecs import read_pfm, read_png
    from diner_tpu_torch.data.dtu import DTUDataset
    from diner_tpu_torch.mvs.datasets import DTUMVSDataset

    listfile = root / "splits" / "dtu_val_all.txt"
    argv = ["write", "--datapath", str(root), "--listfile", str(listfile)]
    args = mvs_cli.parser().parse_args(argv)
    ds = DTUMVSDataset(root, listfile, mode="write_prediction")
    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    seconds = mvs_cli.main(argv)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = _launches()
    check(launches == _expect(), f"mvs write launched {launches}")
    check(len(seconds) == 4, f"mvs write: {len(seconds)} samples, expected 4")
    log(f"mvs write: {len(seconds)} DTU samples (4 views at 512x640, ndepths "
        f"{args.ndepths} of {args.numdepth}, base channels "
        f"{args.base_channels or 8}, random weights "
        f"from seed {args.seed}, cuDNN TF32 at torch's default "
        f"{torch.backends.cudnn.allow_tf32}): "
        f"{statistics.fmean(seconds[1:]):.4f} s per sample after the first "
        f"({[round(x, 4) for x in seconds]}; read, cascade and PNGs), peak "
        f"memory {peak:.2f} GiB [{card}]; launches {launches}")

    # the 12 files, decoded: depth inside the cascade's reach (less one PNG
    # unit), confidence in [0, 1]
    lo, hi = _mvs_reach(args, ds[0]["depth_values"])
    unit = 1e-4 * 872.0 / 0.7      # cli/mvs's DTU scale: depth / (872 / 0.7)
    written = []
    for cam in DTUDataset.SRC_CAM_IDCS:
        stem = root / "Depths" / "scan1" / f"depth_map_{cam:04d}_TransMVSNet"
        files = [stem.with_name(stem.name + s + ".png")
                 for s in ("", "_conf", "_vis")]
        depth, conf, vis = (read_png(f) for f in files)
        depth = depth * unit
        conf = conf * 1e-4
        check(all(f.stat().st_mtime >= t0 - 1 for f in files)
              and depth.shape == conf.shape == vis.shape == (512, 640)
              and vis.dtype == np.uint8 and np.isfinite(depth).all()
              and depth.min() >= max(lo, 0) - unit and depth.max() <= hi
              and 0 <= conf.min() and conf.max() <= 1,
              f"mvs write: {stem.name}: depth {depth.min()}..{depth.max()} "
              f"of {lo}..{hi}, conf {conf.min()}..{conf.max()}")
        written += files[:2]
    log(f"mvs write: 12 PNGs decoded, depth inside the cascade's reach "
        f"{lo:.1f}..{hi:.1f} mm, confidence in [0, 1]")

    net = mvs_cli.build_net(args, torch.device("cuda"))
    batch = mvs_cli.batch_of(ds[0], torch.device("cuda"))
    _mvs_profile(net, batch, card)

    # render_eval from the priors just written: the DTU reader must read
    # every one of them
    read = []
    plain = dtu_reader.read_png16

    def spy(path):
        read.append(Path(path))
        return plain(path)

    dtu_reader.read_png16 = spy
    try:
        hw = (int(512 * DTU_DOWNSAMPLE), int(640 * DTU_DOWNSAMPLE))
        with tempfile.TemporaryDirectory(dir=DATA_DIR) as tmp:
            _eval_preset("mvs_render_eval", DTU_PRESET, _dtu_data(root),
                         DTUDataset, 1, hw, card, Path(tmp))
    finally:
        dtu_reader.read_png16 = plain
    check(set(written) <= set(read), f"render_eval read {sorted(set(read))}"
          f", not every prior of {written}")
    log(f"mvs render_eval: read the {len(written)} depth and confidence "
        f"priors just written")

    differs = _mvs_card_vs_cpu(net, ds[0], card)
    check(differs < 0.01, f"mvs: final depth differs at {differs} of the "
          f"pixels")
    del net, batch

    # the eval outputs stay for phase_fuse
    write_mvs_eval_scan(eval_root / "scan1")
    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    seconds = mvs_cli.main(["eval", "--datapath", str(eval_root),
                            "--testlist", "scan1", "--outdir",
                            str(eval_root / "out"), "--img_ext", ".png"])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(_launches() == _expect(), f"mvs eval launched {_launches()}")
    out = eval_root / "out" / "scan1"
    lo, hi = _mvs_reach(args, 425.0 + np.arange(args.numdepth) * 2.5 * 1.06)
    for ref in range(MVS_EVAL_VIEWS):
        depth, _ = read_pfm(out / "depth_est" / f"{ref:08d}.pfm")
        conf, _ = read_pfm(out / "confidence" / f"{ref:08d}.pfm")
        img = read_png(out / "images" / f"{ref:08d}.png")
        check(depth.shape == conf.shape == MVS_EVAL_HW
              and img.shape == (*MVS_EVAL_HW, 3)
              and np.isfinite(depth).all() and depth.min() >= lo - 1e-3
              and depth.max() <= hi + 1e-3 and np.isfinite(conf).all()
              and conf.min() >= 0 and conf.max() <= 1
              and (out / "cams" / f"{ref:08d}_cam.txt").exists(),
              f"mvs eval view {ref}: depth {depth.shape} "
              f"{depth.min()}..{depth.max()}, conf {conf.min()}.."
              f"{conf.max()}")
    log(f"mvs eval: {MVS_EVAL_VIEWS} reference views at {MVS_EVAL_HW[0]}x"
        f"{MVS_EVAL_HW[1]} with {MVS_EVAL_VIEWS} views each, "
        f"{[round(x, 4) for x in seconds]} s per view (the first warms up), "
        f"peak memory {peak:.2f} GiB [{card}]; "
        f"depth_est, confidence, cams and images checked")


def _dtu_mvs_cam():
    """The DTU tree's full-resolution K (512x640) and the MVS hypotheses of
    its cam files: depth_min 425 mm, interval 2.5 x 1.06, 192 bins."""
    import numpy as np

    K = np.array([[0.9 * 640, 0, 320], [0, 0.9 * 640, 256], [0, 0, 1]],
                 np.float32)
    dmin, dint = 425.0, 2.5 * 1.06
    return K, dmin, dmin + dint * (MVS_NUMDEPTH - 1)


def write_dtu_gt_depths(root: Path, card):
    """The GT depth maps Depths/scan1/depth_map_XXXX.pfm (512x640, mm, the
    cam files' unit) of every corner view DTUMVSDataset trains on, from the
    sphere scene that write_dtu_tree rendered: depth where it lies inside
    the cam files' hypotheses, 0 (masked) elsewhere. Returns the ids."""
    import numpy as np

    from diner_tpu_torch.data.codecs import write_pfm
    from diner_tpu_torch.data.dtu import DTUDataset
    from diner_tpu_torch.mvs.datasets import corner_view_metas

    t = time.perf_counter()
    K, dmin, dmax = _dtu_mvs_cam()
    grid = _dtu_grid()
    ids = sorted({tgt for tgt, _ in corner_view_metas("train")})
    views = _sphere_views(512, 640, DTU_SCENE_SCALE, [grid[i] for i in ids],
                          K)
    kept = fg = 0
    for i, (_, _, d) in zip(ids, views):
        mm = d[..., 0] / DTUDataset.SCALE_FACTOR_DEFAULT
        gt = np.where((mm >= dmin) & (mm <= dmax), mm, 0.0).astype(np.float32)
        write_pfm(root / "Depths" / "scan1" / f"depth_map_{i:04d}.pfm", gt)
        kept += int((gt > 0).sum())
        fg += int((mm > 0).sum())
        check(gt.shape == (512, 640) and ((gt == 0) | ((gt >= dmin)
                                                       & (gt <= dmax))).all(),
              f"GT depth of cam {i} outside {dmin}..{dmax}")
    check(kept > 0.2 * fg, f"GT: only {kept} of {fg} foreground pixels "
          f"inside the hypotheses {dmin}..{dmax} mm")
    log(f"mvs_train: GT depth PFMs of {len(ids)} corner cams at 512x640, "
        f"{kept} of {fg} foreground pixels inside the hypotheses "
        f"{dmin:.1f}..{dmax:.1f} mm (the rest masked), written in "
        f"{time.perf_counter() - t:.2f} s")
    return ids


def write_bld_tree(root: Path):
    """The sphere scene in the BlendedMVS layout at BLD_HW: 5 cams of the
    DTU grid (full-resolution K, mm), JPEG images, the rendered depth maps
    (mm) and a pair.txt with every view a reference of the 4 others; the
    cam files' bounds [700, 1100] mm hold the scene's depths."""
    import numpy as np
    from PIL import Image

    from diner_tpu_torch.data.codecs import write_pfm
    from diner_tpu_torch.data.dtu import DTUDataset

    H_, W_ = BLD_HW
    K = np.array([[0.9 * W_, 0, W_ / 2], [0, 0.9 * W_, H_ / 2], [0, 0, 1]],
                 np.float32)
    grid = _dtu_grid()
    exts = [grid[i] for i in (24, 23, 25, 17, 31)]
    views = _sphere_views(H_, W_, DTU_SCENE_SCALE, exts, K)
    scan = root / "sphere"
    for sub in ("blended_images", "cams", "rendered_depth_maps"):
        (scan / sub).mkdir(parents=True)
    sf = DTUDataset.SCALE_FACTOR_DEFAULT
    for v, (e, (rgb, _, d)) in enumerate(zip(exts, views)):
        Image.fromarray(_u8(rgb)).save(scan / "blended_images" /
                                       f"{v:08d}.jpg", quality=95)
        mm = e.copy()
        mm[:3, 3] /= sf
        lines = ["extrinsic"] + [" ".join(f"{x:.6f}" for x in row)
                                 for row in mm]
        lines += ["", "intrinsic"] + [" ".join(f"{x:.6f}" for x in row)
                                      for row in K]
        lines += ["", f"700.0 {400.0 / MVS_NUMDEPTH:.6f} {MVS_NUMDEPTH} "
                      f"1100.0"]
        (scan / "cams" / f"{v:08d}_cam.txt").write_text("\n".join(lines)
                                                        + "\n")
        write_pfm(scan / "rendered_depth_maps" / f"{v:08d}.pfm",
                  (d[..., 0] / sf).astype(np.float32))
    pair = [str(len(exts))]
    for ref in range(len(exts)):
        srcs = [s for s in range(len(exts)) if s != ref]
        pair += [str(ref), f"{len(srcs)} " + " ".join(f"{s} 100.0"
                                                      for s in srcs)]
    (scan / "cams" / "pair.txt").write_text("\n".join(pair) + "\n")
    (root / "list.txt").write_text("sphere\n")
    return root / "list.txt"


def _mvs_train_card_vs_cpu(sample, card):
    """One train step of the cascade (random weights from seed 0, batch 1)
    on the card with TF32 off against the same step on the CPU: the loss
    within 1e-3 relative (a rounding of the stage-2 and stage-3 hypotheses
    may move a GT pixel to the next bin), the gradients of MVS_GRAD_CHECK
    within 1e-2 of each tensor's largest entry (float32 backward sums in
    other orders and algorithms; the deep ones are the least conditioned),
    every BatchNorm running statistic within 1e-5 + 1e-4 relative."""
    import torch

    from diner_tpu_torch.mvs.net import TransMVSNet
    from diner_tpu_torch.data import collate
    from diner_tpu_torch.mvs.train import cascade_loss

    torch.manual_seed(0)
    sd = TransMVSNet().state_dict()

    def step(dev):
        net = TransMVSNet()
        net.load_state_dict(sd)
        net.to(dev).train()
        t = time.perf_counter()
        total, _ = cascade_loss(net, collate([sample]), torch.device(dev),
                                (0.5, 1.0, 2.0))
        total.backward()
        loss = total.item()
        params = dict(net.named_parameters())
        return (loss, time.perf_counter() - t,
                {n: params[n].grad.cpu() for n in MVS_GRAD_CHECK},
                {k: v.cpu() for k, v in net.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))})

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        (lg, _, gg, sg), (lc, cpu_s, gc, sc) = (step(d) for d in ("cuda",
                                                                  "cpu"))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    loss_rel = abs(lg - lc) / abs(lc)
    grad_rel = {n: float((gg[n] - gc[n]).abs().max() / gc[n].abs().max())
                for n in MVS_GRAD_CHECK}
    stat_err = max(float(((sg[k] - sc[k]).abs()
                          / (1e-5 + 1e-4 * sc[k].abs())).max()) for k in sc)
    log(f"mvs_train card vs cpu (TF32 off, one step at 512x640, "
        f"batch 1; the CPU took {cpu_s:.2f} s): loss {lg:.6f} vs {lc:.6f} "
        f"({loss_rel:.2e} rel); gradients, max |diff| / max |cpu|: "
        + ", ".join(f"{n} {v:.2e}" for n, v in grad_rel.items())
        + f"; {len(sc)} BatchNorm running statistics at {stat_err:.3f} of "
        f"their tolerance [{card}]")
    check(loss_rel <= 1e-3, f"mvs_train card vs cpu: loss {lg} vs {lc}")
    check(all(v <= 1e-2 for v in grad_rel.values()),
          f"mvs_train card vs cpu: gradients {grad_rel}")
    check(stat_err <= 1.0, f"mvs_train card vs cpu: running statistics "
          f"at {stat_err} of their tolerance")


def phase_mvs_train(root: Path, card, tmp: Path):
    """MVS training at the reference DTU configuration (512x640, ndepths
    48/32/8 of 192, batch 1, random weights from seed 0) on the DTU tree
    with GT depths added: cli/mvs train for MVS_TRAIN_STEPS with a save
    every MVS_SAVE_EVERY and --profile, then --resume to
    MVS_TRAIN_STEPS + MVS_RESUME_STEPS; the card against the CPU on one
    step; write --ckpt from the trained checkpoint on the 4 corner
    samples; finetune on a BlendedMVS tree from that checkpoint. No kernel
    launches."""
    import numpy as np
    import torch

    from diner_tpu_torch.cli import mvs as mvs_cli
    from diner_tpu_torch.data.codecs import read_png
    from diner_tpu_torch.data.dtu import DTUDataset
    from diner_tpu_torch.mvs.datasets import DTUMVSDataset
    from diner_tpu_torch.train import ckpt_io

    t_phase = time.perf_counter()
    write_dtu_gt_depths(root, card)
    listfile = root / "splits" / "dtu_train_all.txt"
    logdir = tmp / "mvs_run"
    argv = ["train", "--datapath", str(root), "--listfile", str(listfile),
            "--logdir", str(logdir), "--batch-size", "1", "--seed", "0",
            "--log-every", "1"]
    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    recs = mvs_cli.main(argv + ["--max-steps", str(MVS_TRAIN_STEPS),
                                "--save-every", str(MVS_SAVE_EVERY),
                                "--profile"])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check((logdir / "trace" / "trace.json").exists(),
          "mvs_train --profile wrote no trace")
    first = ckpt_io.restore_latest(logdir / "ckpts", MVS_TRAIN_STEPS)[0]
    end = MVS_TRAIN_STEPS + MVS_RESUME_STEPS
    recs2 = mvs_cli.main(argv + ["--max-steps", str(end), "--resume"])
    check(_launches() == _expect(), f"mvs train launched {_launches()}")
    check([r["step"] for r in recs] == list(range(MVS_TRAIN_STEPS))
          and [r["step"] for r in recs2] == list(range(MVS_TRAIN_STEPS,
                                                       end)),
          f"mvs train steps {[r['step'] for r in recs + recs2]}")
    losses = [r["loss"] for r in recs + recs2]
    check(all(np.isfinite(v) for r in recs + recs2 for v in r.values()),
          f"mvs train: non-finite losses {losses}")
    check(ckpt_io.all_steps(logdir / "ckpts")
          == [MVS_SAVE_EVERY, MVS_TRAIN_STEPS, end],
          f"mvs train checkpoints {ckpt_io.all_steps(logdir / 'ckpts')}")
    counts = {int(s["step"]) for s in first["optimizer"]["state"].values()}
    last = ckpt_io.restore_latest(logdir / "ckpts")[0]
    counts_end = {int(s["step"]) for s in last["optimizer"]["state"].values()}
    check(counts == {MVS_TRAIN_STEPS} and counts_end == {end},
          f"mvs train: Adam's counts {counts} at the resume, {counts_end} "
          f"at the end")
    # after warm-up: not step 0, not the profiled steps 5-9, not the
    # resumed run's first step
    secs = ([r["seconds"] for r in recs[1:5] + recs[10:]]
            + [r["seconds"] for r in recs2[1:]])
    log(f"mvs_train: cli/mvs train at 512x640, ndepths 48,32,8 of "
        f"{MVS_NUMDEPTH}, batch 1, lr 1e-3 (the first update at lr 0), "
        f"{len(DTUMVSDataset(root, listfile, mode='train'))} samples: "
        f"{MVS_TRAIN_STEPS} steps, --resume from step {MVS_TRAIN_STEPS} "
        f"(Adam's count {MVS_TRAIN_STEPS}) to {end} (count {end}); "
        f"s/step after warm-up median {statistics.median(secs):.4f}, min "
        f"{min(secs):.4f}, max {max(secs):.4f} ({len(secs)} steps; "
        f"read, step and a sync), peak memory {peak:.2f} GiB [{card}]; "
        f"losses {[round(v, 4) for v in losses]}")

    sample = DTUMVSDataset(root, listfile, mode="train")[0]
    _mvs_train_card_vs_cpu(sample, card)

    # write --ckpt: the trained weights replace phase_mvs's random ones
    val = root / "splits" / "dtu_val_all.txt"
    pngs = [root / "Depths" / "scan1" / f"depth_map_{c:04d}_TransMVSNet.png"
            for c in DTUDataset.SRC_CAM_IDCS]
    before = [read_png(p) for p in pngs]
    wargv = ["write", "--datapath", str(root), "--listfile", str(val),
             "--ckpt", str(logdir / "ckpts")]
    net = mvs_cli.build_net(mvs_cli.parser().parse_args(wargv),
                            torch.device("cuda"))
    held = net.state_dict()
    check(all(torch.equal(v.cpu(), held[k].cpu())
              for k, v in last["model"].items()) and len(held) == len(
                  last["model"]),
          "write --ckpt: the net does not hold the checkpoint's state_dict")
    del net, held
    _zero_launches()
    seconds = mvs_cli.main(wargv)
    check(_launches() == _expect(), f"mvs write --ckpt launched "
          f"{_launches()}")
    moved = [float((read_png(p).astype(np.int64) - b).__abs__().mean())
             for p, b in zip(pngs, before)]
    check(len(seconds) == 4 and all(m > 0 for m in moved),
          f"write --ckpt: {len(seconds)} samples, mean |PNG change| {moved}")
    log(f"mvs_train: write --ckpt {logdir.name}/ckpts (step {end}) on the 4 "
        f"corner samples: the net holds the checkpoint's state_dict; the "
        f"depth PNGs moved from phase mvs's random-weight ones by "
        f"{[round(m, 1) for m in moved]} units on average; "
        f"{[round(x, 4) for x in seconds]} s per sample [{card}]")

    bld_list = write_bld_tree(tmp / "bld")
    ft = mvs_cli.main(["finetune", "--datapath", str(tmp / "bld"),
                       "--listfile", str(bld_list), "--logdir",
                       str(tmp / "mvs_ft"), "--torch-ckpt",
                       str(ckpt_io.checkpoint_path(logdir / "ckpts", end)),
                       "--max-steps", str(MVS_FINETUNE_STEPS),
                       "--log-every", "1"])
    check([r["step"] for r in ft] == list(range(MVS_FINETUNE_STEPS))
          and all(np.isfinite(v) for r in ft for v in r.values())
          and all({"epe", "less1", "less3"} <= set(r) for r in ft),
          f"finetune: {ft}")
    check(_launches() == _expect(), f"mvs finetune launched {_launches()}")
    log(f"mvs_train: finetune (--dataset bld by default) from the step-{end}"
        f" checkpoint, {MVS_FINETUNE_STEPS} steps on a BlendedMVS tree "
        f"(5 views at {BLD_HW[0]}x{BLD_HW[1]}, 4 a sample): losses "
        f"{[round(r['loss'], 4) for r in ft]}, epe "
        f"{[round(r['epe'], 3) for r in ft]}, s/step "
        f"{[round(r['seconds'], 4) for r in ft]} [{card}]")
    log(f"mvs_train: phase took {time.perf_counter() - t_phase:.1f} s")


def _mvs_write_run(root: Path, flags):
    """cli/mvs write at the reference width with `flags`: (seconds per
    sample, peak GiB, {dpath: the float depth handed to the PNG writer})."""
    import numpy as np
    import torch

    import diner_tpu_torch.mvs.write_prediction as wp
    from diner_tpu_torch.cli import mvs as mvs_cli

    listfile = root / "splits" / "dtu_val_all.txt"
    real = wp.write_depth_prediction
    got = {}

    def spy(depth, conf, dpath, scale=1.0):
        got[str(dpath)] = np.array(depth)
        return real(depth, conf, dpath, scale=scale)

    wp.write_depth_prediction = spy
    gc_cuda()
    torch.cuda.reset_peak_memory_stats()
    try:
        seconds = mvs_cli.main(["write", "--datapath", str(root),
                                "--listfile", str(listfile), *flags])
    finally:
        wp.write_depth_prediction = real
    torch.cuda.synchronize()
    return seconds, torch.cuda.max_memory_allocated() / 2 ** 30, got


def gc_cuda():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _mvs_option_profiles(root: Path, listfile: Path, card):
    """The device time by operator of one write sample and of one training
    step at batch 1 (after a warm-up step), with the window DCN and with
    bfloat16."""
    import torch

    from diner_tpu_torch.cli import mvs as mvs_cli
    from diner_tpu_torch.data import collate
    from diner_tpu_torch.mvs.datasets import DTUMVSDataset
    from diner_tpu_torch.mvs.train import cascade_loss

    dev = torch.device("cuda")
    sample = DTUMVSDataset(root, listfile, mode="write_prediction")[0]
    train = collate([DTUMVSDataset(root, root / "splits" /
                                   "dtu_train_all.txt", mode="train")[0]])
    for label, flags in (("window", ["--dcn-impl", "window"]),
                         ("bf16", ["--compute-dtype", "bfloat16"])):
        args = mvs_cli.parser().parse_args(
            ["write", "--datapath", str(root), "--listfile", str(listfile),
             *flags])
        net = mvs_cli.build_net(args, dev)
        _mvs_profile(net, mvs_cli.batch_of(sample, dev), card,
                     f"mvs_options profile: write {label}, one sample")
        net.train()

        def step():
            total, _ = cascade_loss(net, train, dev, (0.5, 1.0, 2.0))
            total.backward()

        step()
        net.zero_grad(set_to_none=True)
        _mvs_profile(net, None, card, f"mvs_options profile: train {label}, "
                     f"one step at batch 1 (forward and backward)", step)
        del net
        gc_cuda()


def _mvs_train_run(root: Path, tmp: Path, flags, batch: int, steps: int):
    """cli/mvs train at the reference width with `flags` at `batch` for
    `steps` steps: (records, peak GiB), or (None, peak GiB at the failure)
    when the card runs out of memory, which is recorded, not hidden."""
    import torch

    from diner_tpu_torch.cli import mvs as mvs_cli

    gc_cuda()
    torch.cuda.reset_peak_memory_stats()
    logdir = tmp / f"opt_{'_'.join(f.strip('-') for f in flags)}_{batch}"
    recs = None
    try:
        recs = mvs_cli.main(["train", "--datapath", str(root), "--listfile",
                             str(root / "splits" / "dtu_train_all.txt"),
                             "--logdir", str(logdir), "--batch-size",
                             str(batch), "--max-steps", str(steps),
                             "--log-every", str(steps), *flags])
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError:
        pass
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gc_cuda()
    return recs, peak, logdir


def phase_mvs_options(root: Path, card, tmp: Path):
    """The cascade's options at the reference DTU width (512x640, ndepths
    48/32/8 of 192, random weights from seed 0) on the DTU tree: write with
    the gather DCN in float32 (phase mvs's priors, again), --dcn-impl
    window and --compute-dtype bfloat16: s per sample and peak memory, and
    the share of pixels whose depth agrees with the gather/float32 one
    (window: within 1e-4 relative; bfloat16: within a tenth of stage 3's
    hypothesis interval); train with each option at batch 1 and 2 for
    MVS_OPTION_STEPS: s/step, peak memory, whether the batch fits (an
    out-of-memory is recorded, not hidden) and, for window, the offset
    audit's max |k + offset| on the trained weights. No kernel launches."""
    import numpy as np
    import torch

    from diner_tpu_torch.cli import mvs as mvs_cli
    from diner_tpu_torch.mvs.datasets import DTUMVSDataset
    from diner_tpu_torch.mvs.net import WINDOW_LIMIT, window_offset_stats
    from diner_tpu_torch.train import ckpt_io

    t_phase = time.perf_counter()
    _zero_launches()
    runs = {}
    for label, flags in (("gather/f32", []),
                         ("window", ["--dcn-impl", "window"]),
                         ("bf16", ["--compute-dtype", "bfloat16"])):
        seconds, peak, depths = _mvs_write_run(root, flags)
        check(len(seconds) == 4 and all(np.isfinite(d).all()
                                        for d in depths.values()),
              f"mvs_options write {label}: {len(seconds)} samples")
        runs[label] = depths
        log(f"mvs_options: write {label} at 512x640: "
            f"{statistics.fmean(seconds[1:]):.4f} s per sample after the "
            f"first ({[round(x, 4) for x in seconds]}), peak memory "
            f"{peak:.2f} GiB [{card}]")
    ref = runs["gather/f32"]
    listfile = root / "splits" / "dtu_val_all.txt"
    dv = DTUMVSDataset(root, listfile, mode="write_prediction")[0][
        "depth_values"]
    interval3 = float(dv[-1] - dv[0]) / len(dv) * 1.0    # stage 3, ratio 1
    agree = {}
    for label in ("window", "bf16"):
        close = []
        for path, d in ref.items():
            diff = np.abs(runs[label][path] - d)
            tol = (1e-4 * np.abs(d) if label == "window"
                   else 0.1 * interval3)
            close.append(diff <= tol)
        agree[label] = float(np.mean(np.concatenate(
            [c.reshape(-1) for c in close])))
    log(f"mvs_options: depth agreeing with gather/f32's: window "
        f"{agree['window']:.6f} of the pixels (within 1e-4 relative), "
        f"bf16 {agree['bf16']:.6f} (within a tenth of stage 3's interval, "
        f"{0.1 * interval3:.4f} mm)")
    # the window DCN equals the gather form at these zero-init offsets, so
    # only WTA near-ties part them; bfloat16 is a different rounding of a
    # random-weight cascade whose probabilities are nearly flat: reported
    check(agree["window"] >= 0.99, f"mvs_options: depth agreement {agree}")

    fits = {}
    for label, flags in (("window", ["--dcn-impl", "window"]),
                         ("bf16", ["--compute-dtype", "bfloat16"])):
        for batch in (1, 2):
            recs, peak, logdir = _mvs_train_run(root, tmp, flags, batch,
                                                MVS_OPTION_STEPS)
            fits[(label, batch)] = recs is not None
            if recs is None:
                log(f"mvs_options: train {label} at batch {batch}: out of "
                    f"memory at {peak:.2f} GiB allocated [{card}]")
                continue
            check(all(np.isfinite(r["loss"]) for r in recs),
                  f"mvs_options train {label} batch {batch}: {recs}")
            secs = [r["seconds"] for r in recs[1:]]
            extra = ""
            if label == "window":
                args = mvs_cli.parser().parse_args(
                    ["write", "--datapath", str(root), "--listfile",
                     str(listfile), "--dcn-impl", "window", "--ckpt",
                     str(logdir / "ckpts")])
                net = mvs_cli.build_net(args, torch.device("cuda"))
                max_disp, _ = window_offset_stats(
                    net, *mvs_cli.batch_of(
                        DTUMVSDataset(root, listfile,
                                      mode="write_prediction")[0],
                        torch.device("cuda")))
                del net
                check(ckpt_io.all_steps(logdir / "ckpts")
                      == [MVS_OPTION_STEPS], "mvs_options: checkpoints")
                extra = (f"; the audit on the trained weights: max |k + "
                         f"offset| {max_disp:.4f} (exact below "
                         f"{WINDOW_LIMIT:.3f})")
            log(f"mvs_options: train {label} at batch {batch}: s/step after "
                f"the first {statistics.median(secs):.4f} (median of "
                f"{[round(x, 4) for x in secs]}), peak memory {peak:.2f} GiB"
                f"{extra} [{card}]")
            gc_cuda()
    check(fits[("window", 1)] and fits[("bf16", 1)],
          f"mvs_options: batch 1 must fit: {fits}")
    log(f"mvs_options: batch 2 fits: window {fits[('window', 2)]}, bf16 "
        f"{fits[('bf16', 2)]} (the gather DCN in float32 runs out of "
        f"memory at batch 2)")
    check(_launches() == _expect(), f"mvs_options launched {_launches()}")
    log(f"mvs_options: phase took {time.perf_counter() - t_phase:.1f} s")


def _mvs_rank_argv(root: Path, logdir: Path, batch: int, width):
    return ["train", "--datapath", str(root), "--listfile",
            str(root / "splits" / "dtu_train_all.txt"), "--logdir",
            str(logdir), "--batch-size", str(batch), "--max-steps",
            str(MVS_RANK_STEPS), "--log-every", "1", *width]


def _mvs_cli_float64(argv):
    """cli/mvs `argv` with the cascade in float64 (its softmax stays
    float32, as the JAX package's does): (records, the net's final
    state_dict on the CPU)."""
    from diner_tpu_torch.cli import mvs as mvs_cli

    held = {}
    real = mvs_cli.build_net

    def build_net(args, device):
        held["net"] = real(args, device).double()
        return held["net"]

    mvs_cli.build_net = build_net
    try:
        with _Exact():
            recs = mvs_cli.main(argv)
    finally:
        mvs_cli.build_net = real
    return recs, {k: v.cpu() for k, v in held.pop("net").state_dict().items()}


def mvs_rank_child(r: int, tmp: Path, coordinator: str, root: Path,
                   plant: bool = False) -> int:
    """Rank r of phase_mvs_ranks, in its own process on cuda:0 over gloo.
    With `plant`, the ranks skip the gradient all-reduce: each steps on
    its own rows' gradient (the fault the phase's gates must refuse)."""
    import torch
    import torch.distributed as dist

    from diner_tpu_torch.parallel import init_multihost, mesh

    if plant:
        mesh.all_reduce_grads_ = lambda params: None
    dev = init_multihost(coordinator, 2, r, device="cuda", backend="gloo")
    torch.cuda.reset_peak_memory_stats()
    recs, sd = _mvs_cli_float64(_mvs_rank_argv(
        root, tmp / "ranks", 1, MVS_RANK_WIDTH) + ["--multihost"])
    torch.save({"recs": recs, "peak": torch.cuda.max_memory_allocated(),
                "sd": sd, "dev": str(dev)}, tmp / f"mvs_rank{r}.pt")
    dist.destroy_process_group()
    return 0


def phase_mvs_ranks(root: Path, card, tmp: Path, plant: bool = False):
    """MVS training across ranks. Two gloo ranks share the card (child
    processes of this script, `cli/mvs train --multihost` at batch 1 each)
    against one process at batch 2, all exact (`_Exact`), the cascade in
    float64 at MVS_RANK_WIDTH: its first stage alone, at a quarter of the
    channels (two float64 ranks of the full width do not fit the card
    beside each other). A random-weight cascade's probabilities are nearly
    flat, and its softmax stays float32: rounding picks another WTA winner
    at near-ties, which moves a later stage's hypotheses (and PixelwiseNet
    routes its gradient through a max over depth), so no tolerance on the
    full cascade's gradient survives two orders of sums (3e-2 of a tensor's
    largest entry in float32 on the H100). MVS_RANK_STEPS steps, the second
    at the warmup's first lr above 0; the gates: the losses within
    MVS_RANK_LOSS_TOL relative; the global gradient, as Adam's first moment
    holds it, within MVS_RANK_GRAD_TOL of each tensor's largest entry or of
    a thousandth of the largest overall; the parameters after the second
    step within a tenth of its lr of the reference's on at least
    MVS_RANK_PARAM_SHARE of the entries (Adam moves each weight by about
    lr times its gradient's sign, which rounding flips where a gradient is
    nearly 0, such as a bias before a BatchNorm); the BatchNorm statistics
    within 1e-7 + 1e-7 relative; the ranks bitwise equal. Every reading is
    logged before the gates. `plant` runs the ranks without the gradient
    all-reduce (`--mvs-ranks-probe`). Then, when sound, one NCCL rank with
    the full cascade at the full width in float32 (torchrun's variables):
    the gradient all-reduce's share of a step."""
    import os

    import numpy as np
    import torch

    from diner_tpu_torch.cli import mvs as mvs_cli
    from diner_tpu_torch.train import ckpt_io

    t_phase = time.perf_counter()
    label = "planted" if plant else "sound"
    tmp = tmp / f"mvs_ranks_{label}"
    tmp.mkdir(parents=True, exist_ok=True)
    gc_cuda()
    torch.cuda.reset_peak_memory_stats()
    ref, ref_sd = _mvs_cli_float64(_mvs_rank_argv(root, tmp / "one", 2,
                                                  MVS_RANK_WIDTH))
    ref_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    gc_cuda()

    coordinator = f"127.0.0.1:{_free_port()}"
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mvs-rank", str(r),
         str(tmp), coordinator, str(root)] + (["--plant"] if plant else []),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=DDP_CHILD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    seconds = time.perf_counter() - t
    for r, (p, out) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"mvs_ranks: rank {r} exited "
                                 f"{p.returncode}:\n{out[-4000:]}")
    outs = [torch.load(tmp / f"mvs_rank{r}.pt", weights_only=False)
            for r in range(2)]
    r0, r1 = outs
    loss_rel = [_rel(a["loss"], b["loss"]) for a, b in zip(r0["recs"], ref)]
    ranks_equal = all(torch.equal(v, r1["sd"][k])
                      for k, v in r0["sd"].items())
    # the steps' global gradient, as Adam's first moment holds it in rank
    # 0's checkpoint and the reference's
    ckpts = [ckpt_io.restore_latest(tmp / run / "ckpts")[0]
             for run in ("ranks", "one")]
    names = list(ref_sd)
    # Adam holds state for the parameters that got a gradient (the later
    # stages' heads get none), keyed by their index among the parameters
    moments = [{i: st["exp_avg"] for i, st in c["optimizer"]["state"].items()}
               for c in ckpts]
    check(moments[0].keys() == moments[1].keys(),
          "mvs_ranks: the ranks' Adam state covers other parameters")
    params = [k for k in names if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    # each tensor against its own largest entry, or against a thousandth of
    # the largest overall where its gradient nearly cancels (the DCN biases
    # just before a BatchNorm, whose gradient is 0 in exact arithmetic; the
    # attention projections' biases)
    top = max(float(b.abs().max()) for b in moments[1].values())
    grad_err = {i: float((moments[0][i] - b).abs().max()
                         / max(float(b.abs().max()), 1e-3 * top))
                for i, b in moments[1].items()}
    worst = max(grad_err, key=grad_err.get)
    for i in sorted(grad_err, key=grad_err.get)[-3:]:
        log(f"mvs_ranks {label}: {params[i]}: gradient off by "
            f"{grad_err[i]:.3e} of its scale; its largest entry "
            f"{float(moments[1][i].abs().max()) / top:.3e} of the largest "
            f"overall")
    # the parameters after the last step, in units of its lr
    lr = ref[-1]["lr"]
    off = {k: (r0["sd"][k] - ref_sd[k]).abs() / lr for k in params}
    within = {k: float((d <= 0.1).double().mean()) for k, d in off.items()}
    n_within = sum(float((d <= 0.1).sum()) for d in off.values())
    share = n_within / sum(d.numel() for d in off.values())
    least = min(within, key=within.get)
    stats_ok = all(torch.allclose(r0["sd"][k], ref_sd[k], atol=1e-7,
                                  rtol=1e-7)
                   for k in names if k.endswith(("running_mean",
                                                 "running_var")))
    log(f"mvs_ranks {label}: 2 gloo ranks sharing the card (batch 1 each, "
        f"{' '.join(MVS_RANK_WIDTH)} at 512x640, float64) against one "
        f"process at batch 2, exact, {MVS_RANK_STEPS} steps (lr "
        f"{[r['lr'] for r in ref]}): {len(grad_err)} parameters with a "
        f"gradient; losses within {max(loss_rel):.2e} relative; the global "
        f"gradient (Adam's first moment) within {grad_err[worst]:.2e} of "
        f"each tensor's largest entry (or 1e-3 of the largest overall) at "
        f"worst ({params[worst]}); the parameters after the last step "
        f"within a tenth of its lr on {share:.6f} of the entries (the "
        f"least tensor {least} at {within[least]:.6f}, the largest "
        f"difference {max(float(d.max()) for d in off.values()):.3f} lr); "
        f"BatchNorm statistics within 1e-7 + 1e-7 relative: {stats_ok}; "
        f"the ranks bitwise equal: {ranks_equal}")
    log(f"mvs_ranks {label}: the reference's s/step "
        f"{[round(r['seconds'], 4) for r in ref]}, peak {ref_peak:.2f} GiB; "
        f"rank 0's {[round(r['seconds'], 4) for r in r0['recs']]}, peak "
        f"{r0['peak'] / 2 ** 30:.2f} GiB, all-reduce "
        f"{[round(r['allreduce_seconds'], 4) for r in r0['recs']]} s (two "
        f"processes on one card over gloo: not a scaling number); both "
        f"ranks done in {seconds:.1f} s with start-up [{card}]")
    check(max(loss_rel) <= MVS_RANK_LOSS_TOL,
          f"mvs_ranks: losses {r0['recs']} against batch 2's {ref}")
    check(ranks_equal, "mvs_ranks: the ranks' weights differ")
    check(lr > 0, f"mvs_ranks: the last step's lr is {lr}")
    check(grad_err[worst] <= MVS_RANK_GRAD_TOL
          and share >= MVS_RANK_PARAM_SHARE and stats_ok,
          f"mvs_ranks: gradient {grad_err[worst]:.3e} off at "
          f"{params[worst]}, parameters within a tenth of the lr on "
          f"{share:.6f}, statistics {stats_ok}")

    # one NCCL rank at the full width
    gc_cuda()
    env = _ddp_env(_free_port())
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    torch.cuda.reset_peak_memory_stats()
    try:
        recs = mvs_cli.main(["train", "--datapath", str(root), "--listfile",
                             str(root / "splits" / "dtu_train_all.txt"),
                             "--logdir", str(tmp / "nccl"), "--batch-size",
                             "1", "--max-steps", str(MVS_NCCL_STEPS),
                             "--log-every", str(MVS_NCCL_STEPS),
                             "--multihost"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = recs[1:]
    share = (sum(r["allreduce_seconds"] for r in steady)
             / sum(r["seconds"] for r in steady))
    check(all(np.isfinite(r["loss"]) for r in recs) and share < 0.02,
          f"mvs_ranks nccl: {recs}")
    log(f"mvs_ranks: one NCCL rank at the full width (batch 1): s/step "
        f"{[round(r['seconds'], 4) for r in recs]}, the gradient "
        f"all-reduce {[round(r['allreduce_seconds'] * 1e3, 3) for r in recs]}"
        f" ms, {share:.4%} of a step after the first; peak {peak:.2f} GiB "
        f"[{card}]")
    check(_launches() == _expect(), f"mvs_ranks launched {_launches()}")
    log(f"mvs_ranks: phase took {time.perf_counter() - t_phase:.1f} s")


def phase_fuse(eval_root: Path, card):
    """cli/mvs fuse with each method on the 5 views' eval outputs of phase
    mvs (864x1152, random weights), at the CLI's thresholds and at
    FUSE_LOOSE (random weights' confidences fall below the default 0.5):
    points, s and peak memory per scan; the normal method's loose PLY
    against the same fuse on the CPU (the counts within 1e-3 of each
    other, for the pixels whose consistency test sits within rounding of a
    threshold, and all but 1e-3 of the points matched within 1e-5 of the
    cloud's extent in the same colour); then consensus fusion of a 49-view
    DTU scan
    at 512x640 (the sphere scene's depths from the DTU grid): s and peak
    memory."""
    import shutil

    import numpy as np
    import torch

    from diner_tpu_torch.cli import mvs as mvs_cli
    from diner_tpu_torch.fusion import consensus_fusion, read_ply

    t_phase = time.perf_counter()
    gc_cuda()
    out = eval_root / "out"
    plys = {}
    for method in ("normal", "dynamic", "consensus"):
        for label, flags in (("defaults", []), ("loose", FUSE_LOOSE)):
            argv = ["fuse", "--datapath", str(eval_root), "--testlist",
                    "scan1", "--outdir", str(out), "--method", method, *flags]
            torch.cuda.reset_peak_memory_stats()
            res = mvs_cli.main(argv)["scan1"]
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            ply = eval_root / f"{method}_{label}.ply"
            shutil.copy(res["ply"], ply)
            plys[method, label] = ply
            check(Path(res["ply"]).name == "mvsnet001_l3.ply"
                  and read_ply(ply)["points"].shape == (res["points"], 3),
                  f"fuse {method} {label}: {res}")
            log(f"fuse: {method} ({label}{' ' if flags else ''}"
                f"{' '.join(flags)}) on {MVS_EVAL_VIEWS} views at "
                f"{MVS_EVAL_HW[0]}x{MVS_EVAL_HW[1]}: {res['points']} points, "
                f"{res['seconds']:.4f} s per scan (reads, fusion, PLY), peak "
                f"{peak:.3f} GiB [{card}]")
    cpu_out = eval_root / "out_cpu"
    shutil.copytree(out, cpu_out)
    mvs_cli.main(["fuse", "--datapath", str(eval_root), "--testlist",
                  "scan1", "--outdir", str(cpu_out), "--method", "normal",
                  *FUSE_LOOSE, "--device", "cpu"])
    a = read_ply(plys["normal", "loose"])
    b = read_ply(cpu_out / "mvsnet001_l3.ply")
    # a pixel whose round trip to a source lands within float32 rounding of
    # a threshold (1 px, 1% depth) may count that source on one device and
    # not on the other: it is kept on one alone (5 of 1,520,528 on the
    # H100), or kept on both with another fused depth (625 points without
    # a match). Such pixels may be up to 1e-3 of the points. The scene is
    # in mm, where one float32 ulp is 6e-5 at 700 mm: the devices' sums in
    # other orders part the points by a few ulps, so the match is relative
    from scipy.spatial import cKDTree

    tol = 1e-5 * float(np.abs(b["points"]).max())
    far, off_colour = 0, 0
    for x, y in ((a, b), (b, a)):
        dist, idx = cKDTree(y["points"]).query(x["points"])
        far += int((dist > tol).sum())
        off_colour += int((x["colors"] != y["colors"][idx]).any(-1).sum())
    allowed = 1e-3 * len(b["points"])
    log(f"fuse: normal (loose) on the card against the CPU: "
        f"{len(a['points'])} and {len(b['points'])} points; points without "
        f"a match within 1e-5 of the cloud's extent ({tol:.2e} mm) {far}, "
        f"of another colour {off_colour}")
    check(len(b["points"]) > 0
          and abs(len(a["points"]) - len(b["points"])) <= allowed
          and far <= allowed and off_colour <= allowed,
          "fuse: the normal method's PLY differs from the CPU's")

    K = np.array([[0.9 * 640, 0, 320], [0, 0.9 * 640, 256], [0, 0, 1]],
                 np.float32)
    exts = _dtu_grid()
    views = _sphere_views(512, 640, DTU_SCENE_SCALE, exts, K)
    depths = np.stack([d[..., 0] for _, _, d in views]).astype(np.float32)
    colors = np.stack([rgb for rgb, _, _ in views]).astype(np.float32)
    gc_cuda()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res = consensus_fusion(depths, np.stack([K] * len(exts)),
                           np.stack(exts).astype(np.float32), colors=colors,
                           device="cuda")
    n = int(res["keep"].sum())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(n > 0 and torch.isfinite(res["points"][res["keep"]]).all(),
          f"fuse: 49-view consensus kept {n} points")
    log(f"fuse: consensus of a {len(exts)}-view DTU scan at 512x640 (the "
        f"sphere scene): {n} points kept of {depths.size}, {secs:.3f} s, "
        f"peak {peak:.2f} GiB [{card}]")
    check(_launches() == _expect(), f"fuse launched {_launches()}")
    log(f"fuse: phase took {time.perf_counter() - t_phase:.1f} s")


def head_mesh(grid, radius, seed=0):
    """A closed UV sphere of `grid` = (n_lat, n_lon), its radius displaced
    by a few seeded ripples (a head-sized blob): vertices (V, 3) float64,
    faces (2 n_lon (n_lat - 1), 3) int64."""
    import numpy as np

    n_lat, n_lon = grid
    rng = np.random.RandomState(seed)
    th = np.linspace(0, np.pi, n_lat + 1)[1:-1]
    ph = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    r = np.ones_like(T)
    for _ in range(4):
        a, k, m, s = rng.uniform(0.01, 0.04), *rng.randint(1, 7, 2), \
            rng.uniform(0, 2 * np.pi)
        r += a * np.sin(k * T + s) * np.cos(m * P + s)
    r *= radius
    ring = np.stack([r * np.sin(T) * np.cos(P), r * np.sin(T) * np.sin(P),
                     r * np.cos(T)], -1).reshape(-1, 3)
    verts = np.concatenate([[[0.0, 0.0, radius]], ring,
                            [[0.0, 0.0, -radius]]])
    idx = 1 + np.arange((n_lat - 1) * n_lon).reshape(n_lat - 1, n_lon)
    nxt = np.roll(idx, -1, axis=1)
    last = len(verts) - 1
    faces = np.concatenate([
        np.stack([np.zeros(n_lon, np.int64), nxt[0], idx[0]], -1),
        np.stack([idx[:-1], nxt[:-1], nxt[1:]], -1).reshape(-1, 3),
        np.stack([idx[:-1], nxt[1:], idx[1:]], -1).reshape(-1, 3),
        np.stack([np.full(n_lon, last), idx[-1], nxt[-1]], -1)])
    return verts, faces.astype(np.int64)


def write_ply_mesh(path: Path, verts, faces):
    """A binary little-endian triangle PLY, the raw scans' format."""
    import numpy as np

    rec = np.empty(len(faces), np.dtype([("n", "u1"), ("i", "<i4", 3)]))
    rec["n"], rec["i"] = 3, faces
    head = (f"ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\nproperty float x\n"
            f"property float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            f"property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(head.encode())
        f.write(np.ascontiguousarray(verts, "<f4").tobytes())
        f.write(rec.tobytes())


def _render_s(fn):
    """fn()'s result and host seconds, the card synchronized after it."""
    import torch

    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _shaded(depth, mask, gain):
    """A view image from a depth render: shade by depth, a per-camera
    colour gain, grey background; uint8 (H, W, 3) on the host."""
    import torch

    d = depth[mask]
    lo, hi = d.min(), d.max()
    t = ((depth - lo) / (hi - lo + 1e-9)).clamp(0, 1)
    rgb = torch.stack([0.8 - 0.5 * t, 0.55 - 0.2 * t, 0.4 + 0.3 * t], -1)
    rgb = rgb * torch.as_tensor(gain, device=rgb.device)
    rgb = torch.where(mask[..., None], rgb, torch.full_like(rgb, 0.5))
    return (rgb.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()


def _facescape_cams(dist):
    """PRE_VIEWS world->cam extrinsics about a head at the origin in the
    FaceScape frame (-y frontal, z up): the four corners of the reader's
    reference grid and four views inside them."""
    import numpy as np

    angles = [(-40, -25), (40, -25), (-40, 25), (40, 25),
              (0, 0), (-12, 0), (12, 0), (0, 8)][:PRE_VIEWS]
    return [_lookat(dist * np.array([np.sin(az) * np.cos(el),
                                     -np.cos(az) * np.cos(el), np.sin(el)]),
                    np.array([0.0, 0.0, -1.0]))
            for az, el in np.radians(angles)]


def write_raw_facescape(root: Path, verts_m, faces):
    """One raw FaceScape subject in the preprocessing's input layout:
    `01_neutral.ply` (the scan in mm, in the raw frame), `01_neutral/` with
    params.json and PRE_VIEWS JPEG views at PRE_RAW_HW, and the
    similarity that aligns the raw frame to the metric head frame (a
    rotation, 1e-3 and a translation). The views shade the head's depth
    rendered on the card. Returns the alignment dict."""
    import numpy as np
    import torch
    from PIL import Image
    from scipy.spatial.transform import Rotation

    from diner_tpu_torch.preprocess.rasterizer import render_depth

    R_a = Rotation.from_euler("xyz", [0.1, -0.25, 0.4]).as_matrix()
    t_a = np.array([0.004, -0.01, 0.02])
    s = 1e-3
    raw = root / "01_neutral"
    raw.mkdir(parents=True)
    write_ply_mesh(root / "01_neutral.ply", (verts_m - t_a) @ R_a / s, faces)
    H_, W_ = PRE_RAW_HW
    K = np.array([[PRE_RAW_FOCAL, 0, W_ / 2], [0, PRE_RAW_FOCAL, H_ / 2],
                  [0, 0, 1]])
    v = torch.as_tensor(verts_m, device="cuda")
    f = torch.as_tensor(faces, device="cuda")
    rng = np.random.RandomState(0)
    params = {}
    for i, e in enumerate(_facescape_cams(1.0)):
        depth, mask = render_depth(v, f, K, e, H_, W_, device="cuda")
        Image.fromarray(_shaded(depth, mask, rng.uniform(0.8, 1.2, 3))).save(
            raw / f"{i}.jpg", quality=90)
        R_e = e[:3, :3] @ R_a
        t_e = (e[:3, 3] + e[:3, :3] @ t_a) / s
        params[f"{i}_K"] = K.tolist()
        params[f"{i}_Rt"] = np.concatenate([R_e, t_e[:, None]], 1).tolist()
        params[f"{i}_distortion"] = [0.01, -0.004, 0.0, 0.0, 0.0]
        params[f"{i}_valid"] = True
    (raw / "params.json").write_text(json.dumps(params))
    Rt = np.eye(4)
    Rt[:3, :3], Rt[:3, 3] = R_a, t_a
    return {"01": {"scale": s, "Rt": Rt.tolist()}}


def write_multiface_krt(path: Path):
    """A MultiFace KRT of PRE_MF_CAMS cams at 1 m (mm units) about a head
    at the origin, at MULTIFACE_RAW: {name: (K, [R|t] in mm)}."""
    import numpy as np

    H_, W_ = MULTIFACE_RAW
    K = np.array([[PRE_MF_FOCAL, 0, W_ / 2], [0, PRE_MF_FOCAL, H_ / 2],
                  [0, 0, 1]])
    n_az, n_el = PRE_MF_CAMS
    cams, lines = {}, []

    def rows(m):
        return [" ".join(repr(float(x)) for x in r) for r in m]

    for j, el in enumerate(np.linspace(-0.3, 0.3, n_el)):
        for i, az in enumerate(np.linspace(-0.5, 0.5, n_az)):
            e = _lookat(np.array([np.sin(az) * np.cos(el), np.sin(el),
                                  -np.cos(az) * np.cos(el)]),
                        np.array([0.0, -1.0, 0.0]))
            rt = e[:3].astype(np.float64)
            rt[:, 3] *= 1000.0
            name = f"4{j:02d}{i:03d}"
            cams[name] = (K, rt)
            lines += [name, *rows(K), "0 0 0 0 0", *rows(rt), ""]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines) + "\n")
    return cams


def phase_preprocess(card, tmp: Path):
    """The offline preprocessing on the card, on synthetic heads (closed
    displaced spheres from seeded numpy draws):
    (a) render_depth of a FaceScape-scan-sized mesh (PRE_SCAN_GRID, 1M
    triangles) at PRE_RAW_HW and of a MultiFace-tracked-mesh-sized one
    (14,000) at MULTIFACE_RAW from its PRE_MF_CAMS cams: ms per view,
    triangles per second, peak memory;
    (b) the card against device="cpu" on one view of a 50,000-triangle
    mesh at PRE_CHECK_HW: depths equal after the float32 cast and masks
    equal on at least PRE_AGREE of the pixels (the rest: `inside` ties on
    an edge, where the card's projection rounds another way), the count
    printed;
    (c) process_subject on a raw FaceScape subject (one pose, PRE_VIEWS
    JPEG views at PRE_RAW_HW, the 1M-triangle binary PLY, a similarity
    alignment), calibrate_pose_dir on its output, then the port's FaceScape
    reader on the processed pose (the GT depth standing in for the MVS
    prior, a constant confidence): s per view;
    (d) render_frame and write_frame_outputs for every cam of a KRT file at
    MULTIFACE_RAW, RGB frames beside them, then the port's MultiFace reader
    on that tree. No kernel launches."""
    import numpy as np
    import torch
    from PIL import Image

    from diner_tpu_torch.data.codecs import read_depth_png, write_png16
    from diner_tpu_torch.data.facescape import FacescapeDataset
    from diner_tpu_torch.data.multiface import MultiFaceDataset, load_krt
    from diner_tpu_torch.fusion.ply import read_ply_mesh
    from diner_tpu_torch.preprocess import color_calib, facescape_pipeline
    from diner_tpu_torch.preprocess import multiface as mf
    from diner_tpu_torch.preprocess.rasterizer import render_depth

    t_phase = time.perf_counter()
    gc_cuda()
    _zero_launches()
    dev = torch.device("cuda")

    # (a) the rasterizer alone
    scan_v, scan_f = head_mesh(PRE_SCAN_GRID, 0.1, seed=0)
    H_, W_ = PRE_RAW_HW
    K = np.array([[PRE_RAW_FOCAL, 0, W_ / 2], [0, PRE_RAW_FOCAL, H_ / 2],
                  [0, 0, 1]])
    cams = _facescape_cams(1.0)
    v, f = torch.as_tensor(scan_v, device=dev), torch.as_tensor(scan_f,
                                                                device=dev)
    render_depth(v, f, K, cams[0], H_, W_, device=dev)       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for e in cams:
        (d, m), s = _render_s(lambda: render_depth(v, f, K, e, H_, W_,
                                                   device=dev))
        secs.append(s)
        check(bool(m.any()) and not bool(m.all())
              and float(d[m].min()) > 0.85 and float(d.max()) < 1.15,
              f"preprocess: the scan's render reads {float(d.max())} m")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = statistics.median(secs) * 1e3
    log(f"preprocess: render_depth of {len(scan_f)} triangles at {H_}x{W_}: "
        f"{ms:.2f} ms per view (median of {len(secs)} views; "
        f"{min(secs) * 1e3:.2f}-{max(secs) * 1e3:.2f}), "
        f"{len(scan_f) / (ms / 1e3):.4g} triangles/s, "
        f"{int(m.sum())} pixels hit, peak {peak:.3f} GiB [{card}]")
    del v, f, d, m
    tr_v, tr_f = head_mesh(PRE_TRACKED_GRID, 100.0, seed=1)     # mm
    krt_path = tmp / "multiface" / "m--20180227--0000--0000000--GHS" / "KRT"
    write_multiface_krt(krt_path)
    krt = load_krt(krt_path)
    Hm, Wm = MULTIFACE_RAW
    v, f = torch.as_tensor(tr_v, device=dev), torch.as_tensor(tr_f,
                                                              device=dev)
    mf.render_frame(v, f, next(iter(krt.values())), Hm, Wm, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    frames, secs = {}, []
    for name, entry in krt.items():
        frames[name], s = _render_s(lambda: mf.render_frame(
            v, f, entry, Hm, Wm, device=dev))
        secs.append(s)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = statistics.median(secs) * 1e3
    check(all(bool(m.any()) for _, m in frames.values()),
          "preprocess: a MultiFace cam saw no head")
    log(f"preprocess: render_frame of {len(tr_f)} triangles at {Hm}x{Wm} "
        f"from {len(krt)} cams: {ms:.3f} ms per view (median; "
        f"{min(secs) * 1e3:.3f}-{max(secs) * 1e3:.3f}), "
        f"{len(tr_f) / (ms / 1e3):.4g} triangles/s, peak {peak:.3f} GiB "
        f"[{card}]")

    # (b) the card against the CPU
    ck_v, ck_f = head_mesh(PRE_CHECK_GRID, 0.1, seed=2)
    Hc, Wc = PRE_CHECK_HW
    Kc = np.array([[2.2 * Wc, 0, Wc / 2 + 0.3], [0, 2.2 * Wc, Hc / 2 - 0.2],
                   [0, 0, 1]])
    ec = _facescape_cams(1.0)[5]
    dg, mg = render_depth(ck_v, ck_f, Kc, ec, Hc, Wc, device="cuda")
    dc, mc = render_depth(ck_v, ck_f, Kc, ec, Hc, Wc, device="cpu")
    dg, mg = dg.cpu().numpy(), mg.cpu().numpy()
    dc, mc = dc.numpy(), mc.numpy()
    off = (dg != dc) | (mg != mc)
    n_off = int(off.sum())
    log(f"preprocess: card vs CPU, {len(ck_f)} triangles at {Hc}x{Wc}: "
        f"{n_off} of {off.size} pixels differ ({int((mg != mc).sum())} in "
        f"the mask), {int(mc.sum())} hit on the CPU")
    check(mc.any() and n_off <= (1 - PRE_AGREE) * off.size,
          f"preprocess: card and CPU renders differ at {n_off} pixels")

    # (c) a raw FaceScape subject through the pipeline, the calibration
    # and the reader
    raw = tmp / "facescape_raw" / "122"
    align = write_raw_facescape(raw, scan_v, scan_f)
    out_root = tmp / "facescape"
    (_, s_subject) = _render_s(lambda: facescape_pipeline.process_subject(
        raw, out_root / "122", align, crop_out=FACESCAPE_HW[0],
        device="cuda"))
    pose = out_root / "122" / "01"
    cams_out = json.loads((pose / "cameras.json").read_text())
    check(len(cams_out) == PRE_VIEWS,
          f"preprocess: process_subject wrote {len(cams_out)} views")
    R = np.asarray(cams_out["0"]["extrinsics"])[:, :3]
    d0 = read_depth_png(pose / "view_00000" / "depth.png")
    check(np.abs(R @ R.T - np.eye(3)).max() < 1e-5
          and 0.85 < d0[d0 > 0].min() and d0.max() < 1.15,
          f"preprocess: processed depth in [{d0[d0 > 0].min()}, {d0.max()}]"
          " m, or the cameras are not rigid")
    verts, faces = read_ply_mesh(raw / "01_neutral.ply")
    a = align["01"]
    Rt = np.asarray(a["Rt"], np.float32)
    verts = facescape_pipeline.apply_similarity(verts, a["scale"],
                                                Rt[:3, :3], Rt[:3, 3])
    transforms, s_calib = _render_s(lambda: color_calib.calibrate_pose_dir(
        pose, verts, faces, device="cuda"))
    check(len(transforms) == PRE_VIEWS
          and all(np.isfinite(A).all() for A in transforms.values()),
          "preprocess: calibrate_pose_dir")
    for view in sorted(pose.glob("view_*")):
        d = read_depth_png(view / "depth.png")
        write_png16(view / "depth_conf.png",
                    np.round(np.where(d > 0, 0.9, 0) / 1e-4))
    ds = FacescapeDataset(out_root, stage="val", val_subjects=["122"],
                          meta_dir=tmp / "facescape_meta",
                          depth_fname="depth.png")
    sample = ds[0]
    check(len(ds) > 0 and sample["target_rgb"].shape == (*FACESCAPE_HW, 3)
          and np.isfinite(sample["src_rgbs"]).all()
          and sample["src_depths"].max() > 0.85,
          f"preprocess: the FaceScape reader on the processed pose "
          f"({len(ds)} metas)")
    log(f"preprocess: FaceScape process_subject, {PRE_VIEWS} JPEG views at "
        f"{H_}x{W_} and {len(faces)} triangles (reads, undistort, render, "
        f"crop, PNGs): {s_subject / PRE_VIEWS:.3f} s per view; "
        f"calibrate_pose_dir {s_calib / PRE_VIEWS:.3f} s per view; the "
        f"reader: {len(ds)} metas, sample {sample['sample_name']} [{card}]")

    # (d) MultiFace frames of every KRT cam, and the reader
    mf_root = krt_path.parent.parent
    seq = "E001_Neutral"
    secs = []
    for name, (depth, mask) in frames.items():
        t = time.perf_counter()
        mf.write_frame_outputs(
            depth, mask,
            mf_root / krt_path.parent.name / "depths" / seq / name
            / "000001.png",
            mf_root / krt_path.parent.name / "masks" / seq / name
            / "000001.png")
        secs.append(time.perf_counter() - t)
        img = mf_root / krt_path.parent.name / "images" / seq / name
        img.mkdir(parents=True)
        Image.fromarray(_shaded(depth, mask, (1.0, 1.0, 1.0))).save(
            img / "000001.png", compress_level=1)
    corners = [f"4{j:02d}{i:03d}" for j, i in
               ((0, 0), (0, PRE_MF_CAMS[0] - 1),
                (PRE_MF_CAMS[1] - 1, PRE_MF_CAMS[0] - 1),
                (PRE_MF_CAMS[1] - 1, 0))]
    centers = [(-rt[:, :3].T @ rt[:, 3]).tolist()
               for rt in (np.asarray(krt[c]["extrin"]) for c in corners)]
    split = tmp / "multiface_meta" / "split.json"
    split.parent.mkdir(parents=True)
    split.write_text(json.dumps({
        "val": {"subjects": [krt_path.parent.name], "sequences": [seq],
                "ref_centers": centers},
        "train": {"subjects": [], "sequences": [], "ref_centers": []}}))
    ds = MultiFaceDataset(mf_root, downsample=8, split_config=split,
                          meta_dir=split.parent)
    sample = ds[0]
    h, w = (Hm // 8) // 32 * 32, (Wm // 8) // 32 * 32
    check(len(ds) == len(krt) - 4
          and sample["target_rgb"].shape == (h, w, 3)
          and sample["src_depths"].max() > 0.85
          and sorted(sample["src_view_ids"].tolist())
          == sorted(int(c) for c in corners),
          f"preprocess: the MultiFace reader on the rendered tree "
          f"({len(ds)} metas)")
    log(f"preprocess: MultiFace write_frame_outputs (uint16 depth and "
        f"mask PNGs at {Hm}x{Wm}): {statistics.fmean(secs):.3f} s per cam; "
        f"the reader: {len(ds)} metas at {h}x{w} [{card}]")
    check(_launches() == _expect(), f"preprocess launched {_launches()}")
    log(f"preprocess: phase took {time.perf_counter() - t_phase:.1f} s")


def mvs_option_profiles() -> int:
    """`python3 chip_smoke.py --mvs-profiles`: the device time by operator
    of one `write` sample and one training step (batch 1, after a warm-up
    step) of the cascade at the reference DTU width with the window DCN
    and with bfloat16, on this script's DTU tree with its GT depths. Apart
    from the main run: torch.profiler takes minutes over the window's
    half a million launches a step."""
    card = phase_card()
    DATA_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=DATA_DIR) as tmp:
        root = Path(tmp) / "dtu"
        write_dtu_tree(root, card)
        write_dtu_gt_depths(root, card)
        _mvs_option_profiles(root, root / "splits" / "dtu_val_all.txt",
                             card)
    return 0


def mvs_ranks_probe() -> int:
    """`python3 chip_smoke.py --mvs-ranks-probe`: phase mvs_options, then
    phase mvs_ranks sound, which must pass, and with its planted fault (no
    gradient all-reduce), which its gates must refuse; prints every
    reading. Exits 0 when all come out so."""
    import torch

    card = phase_card()
    DATA_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=DATA_DIR) as tmp:
        root = Path(tmp) / "dtu"
        write_dtu_tree(root, card)
        write_dtu_gt_depths(root, card)
        phase_mvs_options(root, card, Path(tmp))
        phase_mvs_ranks(root, card, Path(tmp))
        log("mvs ranks probe: the sound run passed")
        try:
            phase_mvs_ranks(root, card, Path(tmp), plant=True)
        except SmokeFailure as e:
            log(f"mvs ranks probe: the planted fault failed the gates: {e}"[
                :2000])
            log(json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}}))
            return 0
    log("mvs ranks probe: the planted fault PASSED the gates")
    return 1


def ddp_gate_probe() -> int:
    """`python3 chip_smoke.py --ddp-gate-probe`: the ddp_two_ranks gate's own
    check on the card. Runs the phase sound, which must pass, and with its
    planted fault (the ranks' last step takes the encoder's gradient from
    rank 0's rows alone), which the gate must refuse; prints both
    readings. Exits 0 when both come out so."""
    import torch

    card = phase_card()
    phase_build()
    DATA_DIR.mkdir(parents=True, exist_ok=True)
    phase_ddp_two_ranks(card)
    log("ddp gate probe: the sound run passed")
    try:
        phase_ddp_two_ranks(card, plant=True)
    except SmokeFailure as e:
        log(f"ddp gate probe: the planted fault failed the gate: {e}")
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    log("ddp gate probe: the planted fault PASSED the gate")
    return 1


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

    if sys.argv[1:2] == ["--ddp-rank"]:   # a rank of phase_ddp_two_ranks
        return ddp_rank_child(int(sys.argv[2]), Path(sys.argv[3]),
                              sys.argv[4], "--plant" in sys.argv[5:])
    if sys.argv[1:2] == ["--mvs-rank"]:   # a rank of phase_mvs_ranks
        return mvs_rank_child(int(sys.argv[2]), Path(sys.argv[3]),
                              sys.argv[4], Path(sys.argv[5]),
                              "--plant" in sys.argv[6:])
    if sys.argv[1:2] == ["--ddp-gate-probe"]:
        return ddp_gate_probe()
    if sys.argv[1:2] == ["--mvs-profiles"]:
        return mvs_option_profiles()
    if sys.argv[1:2] == ["--mvs-ranks-probe"]:
        return mvs_ranks_probe()

    t0 = time.perf_counter()
    try:
        card = phase_card()
        phase_build()
        flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
        kernels = [phase_k1(flush), phase_k2(flush), phase_k3(flush),
                   phase_k4(flush), phase_k4_backward(flush)]
        del flush
        launches = phase_serve(card)
        phase_facescape(card)
        for extra in (phase_render_options(card), phase_pipelined(card),
                      phase_sharded(card)):
            for n in ("likelihood_from_anchors", "remap_anchors",
                      "composite_rays"):
                launches[n] += extra[n]
        phase_quality()
        DATA_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=DATA_DIR) as tmp:
            work = Path(tmp)
            phase_eval(card, work / "eval")
            backward, train_lines, train_s_step = phase_train(card)
            launches["composite_rays_backward"] = backward
            for ddp in (phase_ddp_nccl(card, train_lines, train_s_step),
                        phase_ddp_two_ranks(card)):
                launches["composite_rays"] += ddp["composite_rays"]
                launches["composite_rays_backward"] += \
                    ddp["composite_rays_backward"]
            dtu_root = work / "dtu"
            write_dtu_tree(dtu_root, card)
            phase_dtu_eval(dtu_root, card)
            phase_lpips(work / "eval", dtu_root, card)
            phase_facescape_eval(card)
            phase_multiface_eval(card)
            phase_sweep(dtu_root, card)
            phase_dtu_train(dtu_root, card)
            phase_mvs(dtu_root, card, work / "mvs_eval")
            phase_mvs_train(dtu_root, card, work)
            phase_mvs_options(dtu_root, card, work)
            phase_mvs_ranks(dtu_root, card, work)
            phase_fuse(work / "mvs_eval", card)
            phase_preprocess(card, work)
        for k in kernels:
            k["launches"] = launches[k["name"]]
    except Exception:  # every phase failure ends the run without a result
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t0:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # the keys every kernel has, then what a phase adds (K4's empty_ms, its
    # backward's gradient_of)
    log(json.dumps({"kernels": [dict({k: kern[k] for k in keys}, **kern)
                                for kern in kernels]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
