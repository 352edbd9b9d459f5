"""K3's plain PyTorch version (frozen copy of the port's
`likelihood_from_chord_plain`)."""

from __future__ import annotations

import math

import torch

N_SCALARS = 8   # [w0, w1, P0, P1, inv_dd, dd_ok, chord_ok, half_step]


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


likelihood_from_chord = likelihood_from_chord_plain
