"""K3: fused chord arithmetic + anchor selection + gated erf-bin likelihood.

Replaces the TPU kernel `likelihood_from_chord`
(diner_tpu/sampler/pallas_likelihood.py:225-276, kernel `_chord_kernel`
142-222). The CUDA kernel is `csrc/chord.cu`, whose header gives its design
and what bounds it on the H100: about 133 MB or 40 us of bytes per chunk at
the fast preset's shapes, and the instructions of its per-candidate work.

The wrapper dispatches on the tensors' device: a CPU tensor runs the plain
PyTorch version, a CUDA tensor launches the kernel. It computes the true erf
(the semantics of the JAX package's XLA path), not the TPU kernel's A&S
polynomial. The chord arithmetic follows `_chord_kernel`'s order of
operations, t = (P0 + z*P1) * inv_dd / zc, which is reassociated against the
default route's (P0 + z*P1) / (zc*dd): the two routes can pick different
anchors at anchor boundaries.
"""

from __future__ import annotations

import ctypes
import math

import torch

from diner_tpu_torch.kernels.build import MAX_SHARED_BYTES, CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("chord", "likelihood_from_chord_launch",
                    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float,
                     _I, _I, _P])
N_SCALARS = 8   # [w0, w1, P0, P1, inv_dd, dd_ok, chord_ok, half_step]
MAX_THREADS = 256


def launch_geometry(SB: int, NV: int, NR: int, NC: int, A: int):
    """(blocks, threads, dynamic shared memory bytes) of one launch: a block
    per ray, a thread per quad of candidates (a multiple of 32, at most 256),
    and each view's 8 scalars and (depth, 1 / (sqrt2 std)) anchor table in
    shared memory. Raises ValueError where that table exceeds what a block
    may use."""
    if A <= 0:
        raise ValueError(f"n_anchors must be positive, got {A}")
    smem = 4 * NV * (N_SCALARS + 2 * A)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"NV={NV} views of A={A} anchors need {smem} bytes "
                         f"of shared memory, above the {MAX_SHARED_BYTES} a "
                         f"block may use")
    quads = -(-NC // 4)
    threads = min(MAX_THREADS, max(32, -(-quads // 32) * 32))
    return SB * NR, threads, smem


def _select(z, scal, vals, A: int, depth_diff_max: float):
    """Cam depths zc, half steps, anchor ids, the selected anchors' depth
    and std, and the gate, each (SB, NV, NR, NC) (hs (SB, NV, NR, 1))."""
    zz = z[:, None]                                        # (SB, 1, NR, NC)
    w0, w1, P0, P1, inv_dd, dd_ok, chord_ok, hs = (
        scal[..., i:i + 1] for i in range(N_SCALARS))      # (SB, NV, NR, 1)
    zc = w0 + zz * w1                                      # (SB, NV, NR, NC)
    front = (chord_ok > 0.0) & (zc > 1e-9)
    zc_safe = torch.where(zc.abs() > 1e-9, zc, torch.ones_like(zc))
    t = (P0 + zz * P1) * inv_dd / zc_safe
    s = torch.where(dd_ok > 0.0, t, torch.full_like(t, 0.5))
    a = (s.clamp(0.0, 1.0) * A).to(torch.int32).clamp(0, A - 1)
    SB, NV, NR, NC = a.shape
    sel = torch.gather(vals, 4, a.long()[:, :, :, None, :].expand(
        SB, NV, NR, 3, NC))
    d, std, cos = sel.unbind(3)
    valid = (front & (cos <= 0) & ((d - zc).abs() < depth_diff_max)
             & (std != 0))
    return zc, hs, a, d, std, valid


def chord_gate(z, scal, vals, n_anchors: int, depth_diff_max: float):
    """(SB, NV, NR, NC) bool: where a candidate passes every gate (in front,
    cos <= 0, std != 0, |d - zc| < depth_diff_max) and gets its erf mass;
    elsewhere p is 0 and the kernel skips both erf."""
    return _select(z, scal, vals, n_anchors, depth_diff_max)[-1]


def likelihood_from_chord_plain(z, scal, vals, n_anchors: int,
                                depth_diff_max: float,
                                return_ids: bool = False):
    """The same function in plain PyTorch, on any device."""
    zc, hs, a, d, std, valid = _select(z, scal, vals, n_anchors,
                                       depth_diff_max)
    sstd = torch.where(std == 0, torch.ones_like(std), std) * math.sqrt(2.0)
    hi = torch.erf((zc + hs - d) / sstd)
    lo = torch.erf((zc - hs - d) / sstd)
    p = torch.where(valid, 0.5 * (hi - lo).abs(), torch.zeros_like(hi))
    return (p, a) if return_ids else p


def _check(z, scal, vals, n_anchors):
    for name, t in (("z", z), ("scal", scal), ("vals", vals)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if z.ndim != 3 or scal.ndim != 4 or vals.ndim != 5:
        raise ValueError(f"expected z (SB, NR, NC), scal (SB, NV, NR, 8) and "
                         f"vals (SB, NV, NR, 3, A), got {tuple(z.shape)}, "
                         f"{tuple(scal.shape)} and {tuple(vals.shape)}")
    SB, NR, _ = z.shape
    NV = scal.shape[1]
    if (tuple(scal.shape) != (SB, NV, NR, N_SCALARS)
            or tuple(vals.shape) != (SB, NV, NR, 3, n_anchors)):
        raise ValueError(
            f"shape mismatch: z {tuple(z.shape)}, scal {tuple(scal.shape)}, "
            f"vals {tuple(vals.shape)}, n_anchors {n_anchors}")
    devices = {t.device for t in (z, scal, vals)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def likelihood_from_chord(z, scal, vals, n_anchors: int,
                          depth_diff_max: float, return_ids: bool = False):
    """Gated likelihood of every candidate in every view, from the chord.

    z: (SB, NR, NC) f32 candidate distances along the ray (the same for
    every view); scal: (SB, NV, NR, 8) f32 per-(view, ray) chord scalars
    [w0, w1, P0, P1, inv_dd, dd_ok, chord_ok, half_step]; vals:
    (SB, NV, NR, 3, A) f32 the anchors' [depth, std, cos]. Returns p
    (SB, NV, NR, NC) f32 with the `front` and chord gates folded in, and with
    return_ids=True also the anchor ids (SB, NV, NR, NC) int32.
    """
    _check(z, scal, vals, n_anchors)
    if z.device.type == "cpu":
        return likelihood_from_chord_plain(z, scal, vals, n_anchors,
                                           depth_diff_max, return_ids)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    SB, NR, NC = z.shape
    NV, A = scal.shape[1], n_anchors
    _, threads, smem = launch_geometry(SB, NV, NR, NC, A)
    z, scal, vals = (t.contiguous() for t in (z, scal, vals))
    p = torch.empty((SB, NV, NR, NC), dtype=torch.float32, device=z.device)
    ids = (torch.empty((SB, NV, NR, NC), dtype=torch.int32, device=z.device)
           if return_ids else None)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch(z.data_ptr(), scal.data_ptr(), vals.data_ptr(),
                      p.data_ptr(), None if ids is None else ids.data_ptr(),
                      SB, NV, NR, NC, A, float(depth_diff_max), threads,
                      smem, stream)
    return (p, ids) if return_ids else p
