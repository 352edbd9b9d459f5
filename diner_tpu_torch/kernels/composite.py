"""K4: per-ray alpha compositing of the field's outputs.

Replaces the TPU kernel `composite_pallas`
(diner_tpu/renderer/pallas_composite.py:76-115, kernel `_composite_kernel`
40-73). The CUDA kernel is `csrc/composite.cu`. It is bound by bytes on the
H100: 2.7 MB or 0.8 us per 4096-ray chunk, below the launch latency, so what
is left is the time from a ray's first load to its last store. A group of
`GROUP` = 16 lanes owns a ray, each lane two consecutive samples of a
32-sample tile: 16-byte streaming loads of the field rows, both alphas at
once with no branch, then a log2(GROUP)-step shuffle scan for the
transmittance and log2(GROUP)-step group sums. A warp per ray (about 30
dependent shuffles a ray) and 8 lanes a ray (four samples a lane) were
slower on the H100; the header of `csrc/composite.cu` gives the design.

`composite_outputs` is the compositing arithmetic in plain PyTorch (the
counterpart of diner_tpu.renderer.composite.composite_outputs); it returns
the weights. `composite_rays` returns what the kernel returns, (rgb, depth,
acc), and dispatches on the tensors' device: a CPU tensor runs the plain
version (autograd differentiates it), a CUDA tensor launches the kernel.
Where the field's outputs require grad, the launch goes through
`CompositeFunction`, whose backward is the kernel of `csrc/composite_bwd.cu`
(its header gives the math). z and the rays get no gradient: the sampler
runs under no_grad. `composite_rays_backward` and its plain version
`composite_rays_backward_plain` (autograd through `composite_rays_plain`)
give the gradient of the field's outputs.

The backward kernel holds a ray's samples in registers: `BACKWARD_GROUP` = 8
lanes a ray, lane l holding sample l of each of P = ceil(K / 8) rows of 8
consecutive samples (at most `BACKWARD_MAX_PER_LANE` = 8 rows), so that
every load and store is coalesced; a 3-step shuffle scan in each row, the
rows side by side, then the rows chained, forward for the transmittance and
backward for the suffix sums; g_field is written once and never read. A ray
of more than 64 samples runs in tiles of 64 and keeps every tile but the
last in shared memory (`backward_geometry` sizes it, up to `BACKWARD_MAX_K`
samples). The kernel it replaced (a warp a ray, a scratch round trip
through g_field) and the designs timed beside this one (P consecutive
samples a lane at 4, 8 and 16 lanes a ray, directly or staged through
shared memory; a persistent grid fed by TMA bulk copies) are in PERF.md.
"""

from __future__ import annotations

import ctypes

import torch

from diner_tpu_torch.kernels.build import MAX_SHARED_BYTES, CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
KERNEL = CudaKernel("composite", "composite_rays_launch",
                    [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _LL, _I, _P])
BACKWARD = CudaKernel("composite_bwd", "composite_rays_backward_launch",
                      [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _LL, _I, _I,
                       _P])
GROUP = 16      # lanes per ray: kGroup of csrc/composite.cu
THREADS = 128   # 8 rays a block
# csrc/composite_bwd.cu: kGroup lanes a ray, at most kMaxPerLane rows (a
# sample each) a lane in registers, at most kMaxThreads threads a block
BACKWARD_GROUP = 8
BACKWARD_MAX_PER_LANE = 8
BACKWARD_THREADS = 128   # 16 rays a block; fewer where shared memory is short
BACKWARD_MAX_K = 1024
MAX_BLOCKS = 2 ** 31 - 1


def _geometry(n_rays: int, K: int, lanes: int, threads: int):
    if K < 1:
        raise ValueError(f"a ray needs at least one sample, got K={K}")
    blocks = -(-n_rays * lanes // threads)
    if blocks > MAX_BLOCKS:
        raise ValueError(f"{n_rays} rays need {blocks} blocks, above the "
                         f"grid's {MAX_BLOCKS}")
    return blocks, threads, 0


def launch_geometry(n_rays: int, K: int):
    """(blocks, threads, dynamic shared memory bytes) of one launch: GROUP
    lanes per ray, THREADS threads a block, no shared memory; no block for
    no ray. Raises ValueError for K < 1 and past the grid's 2^31 - 1
    blocks."""
    return _geometry(n_rays, K, GROUP, THREADS)


def backward_geometry(n_rays: int, K: int):
    """The same for the backward kernel: BACKWARD_GROUP lanes per ray, each
    holding one sample of each of P = min(ceil(K / BACKWARD_GROUP),
    BACKWARD_MAX_PER_LANE) rows. A ray of more than one tile of
    BACKWARD_GROUP * P samples keeps every tile but the last in shared
    memory, 16 bytes a sample, so the block shrinks from BACKWARD_THREADS
    to 64 threads where that does not fit in MAX_SHARED_BYTES (K above
    960). Raises ValueError for K < 1, past BACKWARD_MAX_K samples and past
    the grid's 2^31 - 1 blocks."""
    if K < 1:
        raise ValueError(f"a ray needs at least one sample, got K={K}")
    if K > BACKWARD_MAX_K:
        raise ValueError(f"K={K} samples a ray is above the backward "
                         f"kernel's {BACKWARD_MAX_K}")
    per_lane = min(-(-K // BACKWARD_GROUP), BACKWARD_MAX_PER_LANE)
    tiles = -(-K // (BACKWARD_GROUP * per_lane))
    per_thread = (tiles - 1) * per_lane * 16
    threads = (BACKWARD_THREADS
               if BACKWARD_THREADS * per_thread <= MAX_SHARED_BYTES else 64)
    blocks, threads, _ = _geometry(n_rays, K, BACKWARD_GROUP, threads)
    return blocks, threads, threads * per_thread


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

    # torch.maximum, like jnp.maximum, splits a tie's gradient evenly
    alphas = 1.0 - torch.exp(-deltas * torch.maximum(sigmas,
                                                      sigmas.new_zeros(())))
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


def composite_rays_backward_plain(rays, z_samp, field_out, g_rgb, g_depth,
                                  g_acc, white_bkgd: bool = False):
    """The gradient of the field's outputs (SB, B*K, 4) from the upstream
    gradients g_rgb (SB, B, 3), g_depth and g_acc (SB, B): autograd through
    `composite_rays_plain`, on any device."""
    with torch.enable_grad():
        field = field_out.detach().requires_grad_(True)
        outs = composite_rays_plain(rays.detach(), z_samp.detach(), field,
                                    white_bkgd)
        return torch.autograd.grad(outs, field, (g_rgb, g_depth, g_acc))[0]


def _launch_backward(rays, z_samp, field_out, g_rgb, g_depth, g_acc,
                     white_bkgd):
    SB, B, K = z_samp.shape
    blocks, threads, shared = backward_geometry(SB * B, K)
    g_field = torch.empty((SB, B * K, 4), dtype=torch.float32,
                          device=z_samp.device)
    if blocks == 0:
        return g_field
    rays, z_samp, field_out, g_rgb, g_depth, g_acc = (
        t.contiguous() for t in (rays, z_samp, field_out, g_rgb, g_depth,
                                 g_acc))
    # the kernel reads and writes the field rows with 16-byte accesses
    if field_out.data_ptr() % 16:
        field_out = field_out.clone()
    with torch.cuda.device(z_samp.device):
        stream = torch.cuda.current_stream(z_samp.device).cuda_stream
        BACKWARD.launch(rays.data_ptr(), z_samp.data_ptr(),
                        field_out.data_ptr(), g_rgb.data_ptr(),
                        g_depth.data_ptr(), g_acc.data_ptr(),
                        g_field.data_ptr(), SB * B, K, int(white_bkgd),
                        blocks, threads, shared, stream)
    return g_field


def composite_rays_backward(rays, z_samp, field_out, g_rgb, g_depth, g_acc,
                            white_bkgd: bool = False):
    """The gradient of K4's outputs with respect to the field's outputs:
    g_rgb (SB, B, 3), g_depth and g_acc (SB, B) f32 -> g_field
    (SB, B*K, 4) f32. A CPU tensor runs the plain version, a CUDA tensor
    launches the backward kernel."""
    _check(rays, z_samp, field_out)
    SB, B, _ = z_samp.shape
    for name, t, shape in (("g_rgb", g_rgb, (SB, B, 3)),
                           ("g_depth", g_depth, (SB, B)),
                           ("g_acc", g_acc, (SB, B))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != z_samp.device:
            raise ValueError(f"{name} on {t.device}, z_samp on "
                             f"{z_samp.device}")
    if z_samp.device.type == "cpu":
        return composite_rays_backward_plain(rays, z_samp, field_out, g_rgb,
                                             g_depth, g_acc, white_bkgd)
    if z_samp.device.type != "cuda":
        raise ValueError(f"unsupported device {z_samp.device}")
    return _launch_backward(rays, z_samp, field_out, g_rgb, g_depth, g_acc,
                            white_bkgd)


class CompositeFunction(torch.autograd.Function):
    """K4 with its backward kernel: forward (rays, z, field_out, white) ->
    (rgb, depth, acc); backward -> the field's gradient only. Saves z, the
    field rows and the rays (for far), not the weights."""

    @staticmethod
    def forward(ctx, rays, z_samp, field_out, white_bkgd):
        ctx.white_bkgd = white_bkgd
        ctx.save_for_backward(rays, z_samp, field_out)
        return _launch_forward(rays, z_samp, field_out, white_bkgd)

    @staticmethod
    def backward(ctx, g_rgb, g_depth, g_acc):
        rays, z_samp, field_out = ctx.saved_tensors
        g_field = _launch_backward(rays, z_samp, field_out, g_rgb, g_depth,
                                   g_acc, ctx.white_bkgd)
        return None, None, g_field, None


def composite_rays(rays, z_samp, field_out, white_bkgd: bool = False):
    """Alpha-composite the field's outputs along each ray.

    rays (SB, B, 8) f32; z_samp (SB, B, K) f32 ascending; field_out
    (SB, B*K, 4) f32 [rgb, sigma] in the field's own layout. Returns
    (rgb (SB, B, 3), depth (SB, B), acc (SB, B)). On a CUDA device, a
    field_out that requires grad gets its gradient from the backward
    kernel; rays and z_samp must not require grad there.
    """
    _check(rays, z_samp, field_out)
    if z_samp.device.type == "cpu":
        return composite_rays_plain(rays, z_samp, field_out, white_bkgd)
    if torch.is_grad_enabled() and (rays.requires_grad
                                    or z_samp.requires_grad):
        raise RuntimeError("the composite_rays kernels give the gradient of "
                           "field_out only: rays and z_samp come from the "
                           "sampler under no_grad")
    if z_samp.device.type != "cuda":
        raise ValueError(f"unsupported device {z_samp.device}")
    if torch.is_grad_enabled() and field_out.requires_grad:
        return CompositeFunction.apply(rays, z_samp, field_out,
                                       bool(white_bkgd))
    return _launch_forward(rays, z_samp, field_out, white_bkgd)


def _launch_forward(rays, z_samp, field_out, white_bkgd):
    SB, B, K = z_samp.shape
    blocks, threads, _ = launch_geometry(SB * B, K)
    dev = z_samp.device
    rgb = torch.empty((SB, B, 3), dtype=torch.float32, device=dev)
    depth = torch.empty((SB, B), dtype=torch.float32, device=dev)
    acc = torch.empty((SB, B), dtype=torch.float32, device=dev)
    if blocks == 0:
        return rgb, depth, acc
    rays, z_samp, field_out = (t.contiguous()
                               for t in (rays, z_samp, field_out))
    # the kernel reads the field rows with 16-byte loads, z with 8-byte ones
    z_samp, field_out = (t if t.data_ptr() % 16 == 0 else t.clone()
                         for t in (z_samp, field_out))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        KERNEL.launch(rays.data_ptr(), z_samp.data_ptr(),
                      field_out.data_ptr(), rgb.data_ptr(), depth.data_ptr(),
                      acc.data_ptr(), SB * B, K, int(white_bkgd), blocks,
                      threads, stream)
    return rgb, depth, acc
