"""Random weights from a seed, drawn on the device in one call.

The program and the reference get the same weights: `fill_` walks a
module's parameters in the order of their names, which the port and the
reference's frozen copy share, and cuts them from one normal draw."""

from __future__ import annotations

import math

import torch

# seeds of the benchmark's independent streams, mixed with the run's seed
STREAMS = {"weights": 1, "frames": 2, "loader": 3, "sample": 4, "steps": 5,
           "scenes": 6}
# the density output of PixelNeRF's head, its initial bias (PixelNeRF's
# sigma_bias_init) and the gain on its weights
SIGMA_OUT, SIGMA_BIAS, SIGMA_GAIN = 3, 0.5, 0.1


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one of the run's streams."""
    return (int(seed) * 1_000_003 + STREAMS[stream] * 7_919) % (2 ** 63 - 1)


def layout(module: torch.nn.Module):
    """[(name, shape)] of the parameters `fill_` draws, in its order."""
    return sorted((n, tuple(p.shape)) for n, p in module.named_parameters())


def fill_(module: torch.nn.Module, seed: int, device) -> None:
    """Overwrite every parameter from one standard-normal draw on `device`:
    a matrix or kernel gets std 1/sqrt(fan in), a norm's scale 1 + 0.1 n,
    every other vector (biases, norm shifts) 0.1 n. Norm statistics
    (buffers) keep their initial values. A radiance field's density head
    (`mlp.lin_out`, output 3) starts where the model's own initialization
    puts it, at SIGMA_BIAS, with its weights scaled by SIGMA_GAIN: the
    field then starts as a fog that varies from point to point, where a
    free draw gives a density of one sign everywhere (an empty or a
    saturated frame)."""
    params = dict(module.named_parameters())
    names = [n for n, _ in layout(module)]
    total = sum(params[n].numel() for n in names)
    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    off = 0
    with torch.no_grad():
        for n in names:
            p = params[n]
            x = flat[off:off + p.numel()].view(p.shape)
            off += p.numel()
            if p.ndim >= 2:
                x = x / math.sqrt(p[0].numel())
            elif n.endswith("weight"):
                x = 1.0 + 0.1 * x
            else:
                x = 0.1 * x
            p.copy_(x)
            if n.endswith("mlp.lin_out.weight"):
                p[SIGMA_OUT] *= SIGMA_GAIN
            elif n.endswith("mlp.lin_out.bias"):
                p[SIGMA_OUT] = SIGMA_BIAS
