"""NeRF positional encoding (port of diner_tpu.nn.posenc).

Layout per input vector (D = d_in, F = num_freqs):
    [x (if include_input), sin(f0*x), cos(f0*x), sin(f1*x), cos(f1*x), ...]
with f_k = freq_factor * 2^k: sin and cos interleaved per frequency.
"""

from __future__ import annotations

import torch


def posenc_dim(d_in: int, num_freqs: int, include_input: bool = True) -> int:
    return num_freqs * 2 * d_in + (d_in if include_input else 0)


def posenc(x, num_freqs: int = 6, freq_factor: float = 6.28,
           include_input: bool = True):
    """Encode (..., D) -> (..., posenc_dim(D))."""
    freqs = freq_factor * (2.0 ** torch.arange(num_freqs, dtype=x.dtype,
                                               device=x.device))
    xf = x[..., None, :] * freqs[:, None]                    # (..., F, D)
    enc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)  # (..., F, 2, D)
    enc = enc.reshape(*x.shape[:-1], num_freqs * 2 * x.shape[-1])
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
