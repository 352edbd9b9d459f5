"""K1: fused anchor remap + gated erf-bin surface likelihood.

Replaces the TPU kernel `likelihood_from_anchors`
(diner_tpu/sampler/pallas_likelihood.py:102-139, kernel `_likelihood_kernel`
46-99). The CUDA kernel is `csrc/likelihood.cu`, whose header gives its
design and its bound on the H100: memory-bound, about 247 MB or 74 us per
chunk at the fast preset's shapes.

The wrapper dispatches on the tensors' device: a CPU tensor runs the plain
PyTorch version, a CUDA tensor launches the kernel. It computes the true erf
(the semantics of the JAX package's XLA path), not the TPU kernel's A&S
polynomial.
"""

from __future__ import annotations

import ctypes
import math

import torch

from diner_tpu_torch.kernels.build import CudaKernel

_P = ctypes.c_void_p
KERNEL = CudaKernel("likelihood", "likelihood_from_anchors_launch",
                    [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_float, _P])
# dynamic shared memory of one block (3 * A floats) stays under the 48 KB a
# launch gets without opting in
MAX_ANCHORS = 4096


def likelihood_from_anchors_plain(a, vals, z_cam, half_step,
                                  depth_diff_max: float,
                                  return_selected: bool = False):
    """The same function in plain PyTorch: torch.gather and the same
    arithmetic, on any device."""
    G, NC = a.shape
    sel = torch.gather(vals, 2, a.long()[:, None, :].expand(G, 3, NC))
    d, std, cos = sel.unbind(1)
    valid = (cos <= 0) & ((d - z_cam).abs() < depth_diff_max) & (std != 0)
    sstd = torch.where(std == 0, torch.ones_like(std), std) * math.sqrt(2.0)
    hi = torch.erf((z_cam + half_step - d) / sstd)
    lo = torch.erf((z_cam - half_step - d) / sstd)
    p = torch.where(valid, 0.5 * (hi - lo).abs(), torch.zeros_like(hi))
    return (p, sel) if return_selected else p


def _check(a, vals, z_cam, half_step):
    if a.dtype != torch.int32:
        raise TypeError(f"a must be int32, got {a.dtype}")
    for name, t in (("vals", vals), ("z_cam", z_cam),
                    ("half_step", half_step)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if a.ndim != 2 or vals.ndim != 3 or vals.shape[1] != 3:
        raise ValueError(f"expected a (G, NC) and vals (G, 3, A), got "
                         f"{tuple(a.shape)} and {tuple(vals.shape)}")
    G, NC = a.shape
    if (vals.shape[0] != G or tuple(z_cam.shape) != (G, NC)
            or tuple(half_step.shape) != (G, 1)):
        raise ValueError(
            f"shape mismatch: a {tuple(a.shape)}, vals {tuple(vals.shape)}, "
            f"z_cam {tuple(z_cam.shape)}, half_step {tuple(half_step.shape)}")
    devices = {t.device for t in (a, vals, z_cam, half_step)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def likelihood_from_anchors(a, vals, z_cam, half_step, depth_diff_max: float,
                            return_selected: bool = False):
    """Gated likelihood of each candidate under its anchor's prior.

    a: (G, NC) int32 anchor ids in [0, A); vals: (G, 3, A) f32 packed
    [anchor depth, anchor std, anchor cos]; z_cam: (G, NC) f32; half_step:
    (G, 1) f32 half the candidate bin width. Returns p (G, NC) f32, and with
    return_selected=True also the selected (G, 3, NC) values (a check of the
    kernel's selection).
    """
    _check(a, vals, z_cam, half_step)
    if a.device.type == "cpu":
        return likelihood_from_anchors_plain(a, vals, z_cam, half_step,
                                             depth_diff_max, return_selected)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    G, NC = a.shape
    A = vals.shape[2]
    if not 0 < A <= MAX_ANCHORS:
        raise ValueError(f"A={A} outside (0, {MAX_ANCHORS}]")
    a, vals, z_cam, half_step = (t.contiguous()
                                 for t in (a, vals, z_cam, half_step))
    out = torch.empty((G, NC), dtype=torch.float32, device=a.device)
    sel = (torch.empty((G, 3, NC), dtype=torch.float32, device=a.device)
           if return_selected else None)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch(a.data_ptr(), vals.data_ptr(), z_cam.data_ptr(),
                      half_step.data_ptr(), out.data_ptr(),
                      None if sel is None else sel.data_ptr(), G, NC, A,
                      float(depth_diff_max), stream)
    return (out, sel) if return_selected else out
