"""K4: per-ray alpha compositing of the field's outputs.

Replaces the TPU kernel `composite_pallas`
(diner_tpu/renderer/pallas_composite.py:76-115, kernel `_composite_kernel`
40-73). The CUDA kernel is `csrc/composite.cu`, whose header gives its
design and its bound on the H100: memory-bound, about 2.8 MB or 0.8 us per
4096-ray chunk, below the launch latency.

`composite_outputs` is the compositing arithmetic in plain PyTorch (the
counterpart of diner_tpu.renderer.composite.composite_outputs); it returns
the weights, which training needs. `composite_rays` returns what the kernel
returns, (rgb, depth, acc), and dispatches on the tensors' device: a CPU
tensor runs the plain version, a CUDA tensor launches the kernel. The kernel
has no backward, so off the CPU it refuses inputs that require grad.
"""

from __future__ import annotations

import ctypes

import torch

from diner_tpu_torch.kernels.build import CudaKernel

_P = ctypes.c_void_p
KERNEL = CudaKernel("composite", "composite_rays_launch",
                    [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                     ctypes.c_int, _P])


def composite_outputs(rays, z_samp, out, white_bkgd: bool = False):
    """Composite field outputs out (SB, B*K, 4) [rgb, sigma] at the points of
    `sample_points`. Returns (weights (SB, B, K), rgb (SB, B, 3),
    depth (SB, B)).

    Last delta = far - z_K; alpha = 1 - exp(-delta * relu(sigma)); the
    transmittance cumprod carries the reference's 1e-10 stabilizer; an
    optional white background adds (1 - sum w)."""
    SB, B, K = z_samp.shape
    deltas = torch.cat([z_samp[..., 1:] - z_samp[..., :-1],
                        rays[..., 7:8] - z_samp[..., -1:]], dim=-1)
    out = out.reshape(SB, B, K, 4)
    rgbs = out[..., :3]
    sigmas = out[..., 3]

    alphas = 1.0 - torch.exp(-deltas * sigmas.clamp(min=0.0))
    trans = torch.cumprod(torch.cat([torch.ones_like(alphas[..., :1]),
                                     1.0 - alphas + 1e-10], dim=-1), dim=-1)
    weights = alphas * trans[..., :-1]

    rgb = (weights[..., None] * rgbs).sum(-2)
    depth = (weights * z_samp).sum(-1)
    if white_bkgd:
        rgb = rgb + (1.0 - weights.sum(-1, keepdim=True))
    return weights, rgb, depth


def composite_rays_plain(rays, z_samp, field_out, white_bkgd: bool = False):
    """The same function in plain PyTorch, on any device."""
    weights, rgb, depth = composite_outputs(rays, z_samp, field_out,
                                            white_bkgd)
    return rgb, depth, weights.sum(-1)


def _check(rays, z_samp, field_out):
    for name, t in (("rays", rays), ("z_samp", z_samp),
                    ("field_out", field_out)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if z_samp.ndim != 3:
        raise ValueError(f"z_samp must be (SB, B, K), got "
                         f"{tuple(z_samp.shape)}")
    SB, B, K = z_samp.shape
    if (tuple(rays.shape) != (SB, B, 8)
            or tuple(field_out.shape) != (SB, B * K, 4)):
        raise ValueError(
            f"expected rays {(SB, B, 8)} and field_out {(SB, B * K, 4)}, got "
            f"{tuple(rays.shape)} and {tuple(field_out.shape)}")
    devices = {t.device for t in (rays, z_samp, field_out)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def composite_rays(rays, z_samp, field_out, white_bkgd: bool = False):
    """Alpha-composite the field's outputs along each ray.

    rays (SB, B, 8) f32; z_samp (SB, B, K) f32 ascending; field_out
    (SB, B*K, 4) f32 [rgb, sigma] in the field's own layout. Returns
    (rgb (SB, B, 3), depth (SB, B), acc (SB, B)).
    """
    _check(rays, z_samp, field_out)
    if z_samp.device.type == "cpu":
        return composite_rays_plain(rays, z_samp, field_out, white_bkgd)
    if any(t.requires_grad for t in (rays, z_samp, field_out)):
        raise RuntimeError("the composite_rays kernel has no backward: use "
                           "composite_outputs where gradients are needed")
    if z_samp.device.type != "cuda":
        raise ValueError(f"unsupported device {z_samp.device}")
    SB, B, K = z_samp.shape
    if K == 0:
        raise ValueError("z_samp has no samples")
    rays, z_samp, field_out = (t.contiguous()
                               for t in (rays, z_samp, field_out))
    dev = z_samp.device
    rgb = torch.empty((SB, B, 3), dtype=torch.float32, device=dev)
    depth = torch.empty((SB, B), dtype=torch.float32, device=dev)
    acc = torch.empty((SB, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch(rays.data_ptr(), z_samp.data_ptr(),
                      field_out.data_ptr(), rgb.data_ptr(), depth.data_ptr(),
                      acc.data_ptr(), SB * B, K, int(white_bkgd), stream)
    return rgb, depth, acc
