"""K2: exact f32 anchor remap, out[g, c, t] = vals[g, c, a[g, t]].

Replaces the TPU kernel `remap_anchors_pallas(exact=True)`
(diner_tpu/sampler/pallas_remap.py:48-81, kernel `_remap_kernel` 29-45). The
CUDA kernel is `csrc/remap.cu`, whose header gives its design and its bound
on the H100: memory-bound, about 21 MB or 6 us per chunk at the fast
preset's shapes.

The wrapper dispatches on the tensors' device: a CPU tensor runs the plain
PyTorch version, a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from diner_tpu_torch.kernels.build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("remap", "remap_anchors_launch",
                    [_P, _P, _P, _I, _I, _I, _I, ctypes.c_longlong, _P])
THREADS = 256


def launch_geometry(G: int, C: int, NS: int):
    """(blocks, threads, dynamic shared memory bytes) of one launch: a
    thread per output of the G x C x NS, 256 threads a block, no shared
    memory."""
    return max(1, -(-G * C * NS // THREADS)), THREADS, 0


def remap_anchors_plain(a, vals):
    """The same function in plain PyTorch (torch.gather), on any device."""
    G, NS = a.shape
    C = vals.shape[1]
    return torch.gather(vals, 2, a.long()[:, None, :].expand(G, C, NS))


def remap_anchors(a, vals):
    """a: (G, NS) int32 ids in [0, K); vals: (G, C, K) f32.
    Returns (G, C, NS) f32, a bit-exact selection."""
    if a.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError(f"expected int32 ids and float32 vals, got "
                        f"{a.dtype} and {vals.dtype}")
    if a.ndim != 2 or vals.ndim != 3 or vals.shape[0] != a.shape[0]:
        raise ValueError(f"expected a (G, NS) and vals (G, C, K), got "
                         f"{tuple(a.shape)} and {tuple(vals.shape)}")
    if a.device != vals.device:
        raise ValueError(f"inputs on {a.device} and {vals.device}")
    if a.device.type == "cpu":
        return remap_anchors_plain(a, vals)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    G, NS = a.shape
    _, C, K = vals.shape
    if K == 0:
        raise ValueError("vals has no anchors")
    blocks = launch_geometry(G, C, NS)[0]
    a, vals = a.contiguous(), vals.contiguous()
    out = torch.empty((G, C, NS), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        KERNEL.launch(a.data_ptr(), vals.data_ptr(), out.data_ptr(), G, C,
                      NS, K, blocks, stream)
    return out
