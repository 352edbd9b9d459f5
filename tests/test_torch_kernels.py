"""diner_tpu_torch's kernels: the plain versions against a numpy/scipy oracle
on the CPU, the wrappers' input checks, the CUDA kernels against their plain
versions on the card, and chip_smoke.py's refusal to print a result without
a card.

This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without them (see README, "PyTorch/CUDA port"); the card tests carry
the `cuda` marker and skip where no CUDA device is present.
"""

import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.special import erf as scipy_erf

from diner_tpu_torch.kernels import (KERNELS, chord, composite,
                                     composite_rays, composite_rays_backward,
                                     composite_rays_backward_plain,
                                     composite_rays_plain,
                                     likelihood_from_anchors,
                                     likelihood_from_anchors_plain,
                                     likelihood_from_chord,
                                     likelihood_from_chord_plain, remap,
                                     remap_anchors, remap_anchors_plain)
from diner_tpu_torch.kernels.build import MAX_SHARED_BYTES
from diner_tpu_torch.kernels.cases import (EDGE_STDS, chord_inputs,
                                           composite_grad_inputs,
                                           composite_inputs, max_abs_diff,
                                           with_edge_cases)


REPO = Path(__file__).resolve().parent.parent


def _t(x):
    return torch.from_numpy(np.array(x))


def k1_inputs(seed, G, A, NC):
    """The inputs of tests/test_sampler.py's fused-likelihood case: sorted
    ids, ~20% sigma = 0, cos of both signs."""
    rng = np.random.RandomState(seed)
    depth = rng.rand(G, A).astype(np.float32) * 2.0 + 1.0
    std = rng.rand(G, A).astype(np.float32) * 0.3
    std[rng.rand(G, A) < 0.2] = 0.0
    cos = rng.rand(G, A).astype(np.float32) - 0.7
    vals = np.stack([depth, std, cos], axis=1)
    a = np.sort(rng.randint(0, A, (G, NC)), axis=-1).astype(np.int32)
    z_cam = rng.rand(G, NC).astype(np.float32) * 2.0 + 1.0
    half_step = rng.rand(G, 1).astype(np.float32) * 0.01 + 0.001
    return a, vals, z_cam, half_step


def test_likelihood_plain_matches_scipy_oracle():
    """The wrapper on CPU tensors runs the plain version (no launch): exact
    selection, and p within 2e-6 abs of the numpy/scipy oracle of
    tests/test_sampler.py (float32 erf ulps of torch vs scipy)."""
    a, vals, z, hs = k1_inputs(11, 13, 16, 120)
    ddm = 0.5
    before = KERNELS["likelihood_from_anchors"].launches
    got, sel = likelihood_from_anchors(_t(a), _t(vals), _t(z), _t(hs), ddm,
                                       return_selected=True)
    assert KERNELS["likelihood_from_anchors"].launches == before
    d, s, c = (np.take_along_axis(vals[:, i], a, axis=-1) for i in range(3))
    np.testing.assert_array_equal(sel.numpy(), np.stack([d, s, c], axis=1))
    valid = (c <= 0) & (np.abs(d - z) < ddm) & (s != 0)
    sstd = np.where(s == 0, 1.0, s) * math.sqrt(2.0)
    ref = np.where(valid, 0.5 * np.abs(scipy_erf((z + hs - d) / sstd)
                                       - scipy_erf((z - hs - d) / sstd)), 0.0)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-6)


def test_remap_plain_is_bitwise_take_along_axis():
    rng = np.random.RandomState(9)
    G, C, K, NC = 10, 2, 16, 40
    vals = rng.rand(G, C, K).astype(np.float32)
    a = np.sort(rng.randint(0, K, (G, NC)), axis=-1).astype(np.int32)
    before = KERNELS["remap_anchors"].launches
    got = remap_anchors(_t(a), _t(vals)).numpy()
    assert KERNELS["remap_anchors"].launches == before
    ref = np.take_along_axis(vals, a[:, None, :].repeat(C, 1), axis=-1)
    np.testing.assert_array_equal(got, ref)


def test_chord_plain_matches_numpy_oracle():
    """K3's wrapper on CPU tensors runs the plain version (no launch). The
    anchor ids equal a numpy float32 oracle that rounds each operation of
    _chord_kernel's order on its own; p is within 2e-6 abs of the scipy erf
    (float32 erf ulps)."""
    SB, NV, NR, NC, A, ddm = 1, 3, 9, 80, 32, 0.05
    z, scal, vals = chord_inputs(5, SB, NV, NR, NC, A)
    before = KERNELS["likelihood_from_chord"].launches
    p, ids = likelihood_from_chord(_t(z), _t(scal), _t(vals), A, ddm,
                                   return_ids=True)
    assert KERNELS["likelihood_from_chord"].launches == before
    w0, w1, P0, P1, inv_dd, dd_ok, chord_ok, hs = np.moveaxis(
        scal[..., None], 3, 0)
    zz = z[:, None]
    zc = w0 + zz * w1
    zs = np.where(np.abs(zc) > 1e-9, zc, np.float32(1.0))
    s = np.where(dd_ok > 0, (P0 + zz * P1) * inv_dd / zs, np.float32(0.5))
    a = np.clip((np.clip(s, 0, 1) * np.float32(A)).astype(np.int32), 0,
                A - 1)
    np.testing.assert_array_equal(ids.numpy(), a)
    d, std, cos = (np.take_along_axis(vals[:, :, :, c], a, -1)
                   for c in range(3))
    valid = ((chord_ok > 0) & (zc > 1e-9) & (cos <= 0)
             & (np.abs(d - zc) < ddm) & (std != 0))
    sstd = np.where(std == 0, 1.0, std) * math.sqrt(2.0)
    ref = np.where(valid, 0.5 * np.abs(scipy_erf((zc + hs - d) / sstd)
                                       - scipy_erf((zc - hs - d) / sstd)), 0)
    assert 0.02 < (ref > 0).mean() < 0.98
    np.testing.assert_allclose(p.numpy(), ref, atol=2e-6)
    assert torch.equal(p, likelihood_from_chord_plain(
        _t(z), _t(scal), _t(vals), A, ddm))


def chord_kernel_model(z, scal, vals, A, ddm):
    """csrc/chord.cu's arithmetic in float32 torch: the chord arithmetic and
    anchor id as the plain version rounds them; per anchor r = 1 / (sqrt2
    std) where cos <= 0 and std != 0, else 0, kept finite (+-FLT_MAX) where
    it overflows; the gate r != 0, in front, |d - zc| < ddm; the erf
    arguments (zc +- hs - d) * r."""
    zz = z[:, None]
    w0, w1, P0, P1, inv_dd, dd_ok, chord_ok, hs = (
        scal[..., i:i + 1] for i in range(8))
    zc = w0 + zz * w1
    zc_safe = torch.where(zc.abs() > 1e-9, zc, torch.ones_like(zc))
    t = (P0 + zz * P1) * inv_dd / zc_safe
    s = torch.where(dd_ok > 0, t, torch.full_like(t, 0.5)).nan_to_num(0.0)
    a = (s.clamp(0.0, 1.0) * A).to(torch.int32).clamp(0, A - 1)
    d, std, cos = vals.unbind(3)
    r = torch.where((cos <= 0) & (std != 0), 1.0 / (std * math.sqrt(2.0)),
                    torch.zeros_like(std))
    big = torch.finfo(torch.float32).max
    r = torch.where(r.isinf(), torch.copysign(torch.full_like(r, big), r), r)
    de, re = (torch.gather(x, 3, a.long()) for x in (d, r))
    gate = (chord_ok > 0) & (zc > 1e-9) & (re != 0) & ((de - zc).abs() < ddm)
    hi = torch.erf((zc + hs - de) * re)
    lo = torch.erf((zc - hs - de) * re)
    return torch.where(gate, 0.5 * (hi - lo).abs(), torch.zeros_like(hi)), a


@pytest.mark.parametrize("NV,A", [(1, 8), (3, 32)])
def test_chord_kernel_arithmetic_matches_plain(NV, A):
    """K3's arithmetic (products by a per-anchor 1 / (sqrt2 std), the r == 0
    gate) against the plain version on the CPU, with std 0, -0, tiny
    (normal and subnormal), negative, +-inf, NaN and overflowing, and cos
    > 0, 0, -0 and NaN: ids equal, p within 2e-6 and NaN exactly where the
    plain version's p is NaN."""
    z, scal, vals = chord_inputs(12, 2, NV, 64, 97, A)
    z, scal, vals = (_t(x) for x in (z, scal, with_edge_cases(vals, NV)))
    ddm = 0.05
    p, ids = chord_kernel_model(z, scal, vals, A, ddm)
    p_ref, ids_ref = likelihood_from_chord_plain(z, scal, vals, A, ddm,
                                                 return_ids=True)
    assert torch.equal(ids, ids_ref)
    assert max_abs_diff(p, p_ref) <= 2e-6
    # the edge values reach the gate: selected NaN stds give NaN p, tiny
    # ones a saturated erf, and every edge std is selected somewhere
    assert p_ref.isnan().any() and (p_ref == 1.0).any()
    gate = chord.chord_gate(z, scal, vals, A, ddm)
    sel_std = torch.gather(vals[:, :, :, 1], 3, ids_ref.long())
    for e in EDGE_STDS:
        hit = sel_std.isnan() if math.isnan(e) else sel_std == e
        assert hit.any(), e
    assert gate.any() and not gate.all()


def test_chord_launch_geometry():
    """K3's launch geometry and shared memory from its wrapper's pure-Python
    helper: a block per ray, a thread per quad of candidates, NV x (8 + 2A)
    floats staged a ray, so NV = 4 takes A = 1,024 (and up to 7,260) and is
    refused beyond 227 KB."""
    assert chord.launch_geometry(1, 4, 4096, 1000, 256) == (4096, 256, 8320)
    blocks, threads, smem = chord.launch_geometry(2, 4, 37, 997, 1024)
    assert (blocks, threads, smem) == (74, 256, 32896)
    assert chord.launch_geometry(1, 3, 5, 80, 8)[1:] == (32, 288)
    assert chord.launch_geometry(1, 4, 1, 8, 7260)[2] <= MAX_SHARED_BYTES
    for bad in ((1, 4, 1, 8, 7261), (1, 4, 1, 8, 0), (1, 16, 1, 8, 2048)):
        with pytest.raises(ValueError):
            chord.launch_geometry(*bad)


def test_remap_launch_geometry():
    """K2's launch geometry from its wrapper's pure-Python helper: a thread
    per output of the G x C x NS, 256 threads a block, no shared memory;
    past 32 bits of outputs too (the kernel indexes in 64 bits)."""
    assert remap.launch_geometry(16384, 1, 32) == (2048, 256, 0)
    assert remap.launch_geometry(1001, 5, 45) == (880, 256, 0)
    assert remap.launch_geometry(1001, 1, 7) == (28, 256, 0)
    assert remap.launch_geometry(0, 1, 32) == (1, 256, 0)
    assert remap.launch_geometry(2 ** 21, 1, 1024)[0] == 2 ** 23


def test_composite_plain_matches_numpy_oracle():
    """K4's wrapper on CPU tensors runs the plain version (no launch), equal
    to a sequential numpy float64 loop over the samples within 1e-6 abs and
    1e-5 rel (float32 rounding), with K not a multiple of 32 and white
    background off and on."""
    rays, z, out = composite_inputs(6, 2, 7, 37)
    SB, B, K = z.shape
    f = out.reshape(SB, B, K, 4).astype(np.float64)
    for white in (False, True):
        before = KERNELS["composite_rays"].launches
        rgb, depth, acc = composite_rays(_t(rays), _t(z), _t(out), white)
        assert KERNELS["composite_rays"].launches == before
        ref_rgb, ref_depth, ref_acc = (np.zeros((SB, B, 3)),
                                       np.zeros((SB, B)), np.zeros((SB, B)))
        for sb in range(SB):
            for b in range(B):
                trans = 1.0
                for k in range(K):
                    nxt = z[sb, b, k + 1] if k + 1 < K else rays[sb, b, 7]
                    alpha = 1.0 - np.exp(-(nxt - z[sb, b, k])
                                         * max(f[sb, b, k, 3], 0.0))
                    w = alpha * trans
                    ref_rgb[sb, b] += w * f[sb, b, k, :3]
                    ref_depth[sb, b] += w * z[sb, b, k]
                    ref_acc[sb, b] += w
                    trans *= 1.0 - alpha + 1e-10
        if white:
            ref_rgb += 1.0 - ref_acc[..., None]
        for got, ref in ((rgb, ref_rgb), (depth, ref_depth), (acc, ref_acc)):
            np.testing.assert_allclose(got.numpy(), ref, atol=1e-6,
                                       rtol=1e-5)


def composite_kernel_model(rays, z, out, white_bkgd):
    """csrc/composite.cu's order of operations in float32 torch: GROUP lanes
    per ray, 32 / GROUP consecutive samples per lane in 32-sample tiles; per
    lane, alpha 0 past K (the kernel's select: its weight is then 0 and its
    factor (1 - 0) + 1e-10 rounds to 1), the transmittance in front of each
    sample and the weighted sums as sequential products and sums; the
    group's Hillis-Steele product scan (shfl_up by 1, 2, 4, ...) and its
    shift to an exclusive product; the tile's carry; per-lane totals over
    the tiles; then the xor tree of the group sums (offsets GROUP / 2, ...,
    1)."""
    SB, B, K = z.shape
    G = composite.GROUP
    P = 32 // G
    T = -(-K // 32)
    N, Kp = SB * B, T * 32
    zr, f = z.reshape(N, K), out.reshape(N, K, 4)
    zn = torch.cat([zr[:, 1:], rays.reshape(N, 8)[:, 7:]], 1)
    alpha = 1.0 - torch.exp(-(zn - zr) * f[..., 3].clamp(min=0.0))

    def tiles(x):  # (N, K) -> (N, T, G, P), zero past K
        return torch.nn.functional.pad(x, (0, Kp - K)).reshape(N, T, G, P)

    alpha = tiles(alpha)
    chans = [tiles(f[..., c]) for c in range(3)] + [tiles(zr)]
    t = torch.ones(N, T, G)
    local = [torch.zeros(N, T, G) for _ in range(5)]   # r, g, b, depth, acc
    for j in range(P):
        w = alpha[..., j] * t
        for c in range(4):
            local[c] = local[c] + w * chans[c][..., j]
        local[4] = local[4] + w
        t = t * ((1.0 - alpha[..., j]) + 1e-10)
    incl, off = t, 1
    while off < G:
        incl = torch.cat([incl[..., :off], incl[..., off:]
                          * incl[..., :-off]], -1)
        off *= 2
    excl = torch.cat([torch.ones(N, T, 1), incl[..., :-1]], -1)
    sums, carry = [torch.zeros(N, G) for _ in range(5)], torch.ones(N, 1)
    for i in range(T):
        pre = carry * excl[:, i]
        sums = [s + pre * lc[:, i] for s, lc in zip(sums, local)]
        carry = carry * incl[:, i, -1:]
    off = G // 2
    while off:
        partner = torch.arange(G) ^ off
        sums = [s + s[:, partner] for s in sums]
        off //= 2
    sr, sg, sb, sd, sw = (s[:, 0] for s in sums)
    rgb = torch.stack([sr, sg, sb], -1)
    if white_bkgd:
        rgb = rgb + (1.0 - sw)[:, None]
    return rgb.reshape(SB, B, 3), sd.reshape(SB, B), sw.reshape(SB, B)


@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("K", [1, 5, 32, 37, 40, 64])
def test_composite_kernel_arithmetic_matches_plain(K, white):
    """K4's order of operations (per-lane local products and sums, the group
    scan, the carry across 32-sample tiles, the group sums' xor tree)
    against the plain version on the CPU, within 1e-5 + 1e-5 |plain|, at K
    below, at and above a tile and odd, with SB = 2 and B = 1001 rays (B is
    not a multiple of the rays per warp, 2 x 1001 not one of the rays per
    block)."""
    rays_per_block = composite.THREADS // composite.GROUP
    assert 2 * 1001 % rays_per_block and 1001 % (32 // composite.GROUP)
    rays, z, out = (_t(x) for x in composite_inputs(K, 2, 1001, K))
    got = composite_kernel_model(rays, z, out, white)
    ref = composite_rays_plain(rays, z, out, white)
    for g, r in zip(got, ref):
        assert ((g - r).abs() <= 1e-5 + 1e-5 * r.abs()).all()


def test_composite_launch_geometry():
    """K4's launch geometry from its wrapper's pure-Python helper: GROUP =
    16 lanes a ray, 128 threads (8 rays) a block, no shared memory, no
    block for no ray; past 2^31 elements of z too (the kernel computes each
    ray's base in 64 bits); refused for K < 1 and past the grid's 2^31 - 1
    blocks."""
    assert composite.launch_geometry(4096, 32) == (512, 128, 0)
    assert composite.launch_geometry(2 * 1001, 37) == (251, 128, 0)
    assert composite.launch_geometry(0, 32) == (0, 128, 0)
    assert composite.launch_geometry(2 ** 26, 64)[0] == 2 ** 23
    assert composite.launch_geometry(2 ** 34 - 8, 32)[0] == 2 ** 31 - 1
    for bad in ((16, 0), (2 ** 34, 32)):
        with pytest.raises(ValueError):
            composite.launch_geometry(*bad)


def test_composite_refuses_grad_off_the_cpu():
    """Off the CPU the kernels give the gradient of field_out only: rays or
    z that require grad raise before any launch (meta tensors stand in for
    the card here). On the CPU the plain version keeps the whole autograd
    graph."""
    shapes = {"rays": (1, 4, 8), "z": (1, 4, 3), "out": (1, 12, 4)}
    for grad_of in ("rays", "z"):
        inputs = [torch.empty(shape, device="meta",
                              requires_grad=name == grad_of)
                  for name, shape in shapes.items()]
        with pytest.raises(RuntimeError, match="field_out only"):
            composite_rays(*inputs)
    rays, z, out = (_t(x) for x in composite_inputs(1, 1, 4, 3))
    out.requires_grad_(True)
    z.requires_grad_(True)
    rgb, _, _ = composite_rays(rays, z, out)
    rgb.sum().backward()
    assert out.grad is not None and torch.isfinite(out.grad).all()
    assert z.grad is not None


def composite_backward_kernel_model(rays, z, out, g_rgb, g_depth, g_acc,
                                    white_bkgd):
    """csrc/composite_bwd.cu's order of operations in float32 torch: a group
    of G = BACKWARD_GROUP lanes a ray; tiles of P = min(ceil(K / G),
    BACKWARD_MAX_PER_LANE) rows of G consecutive samples, lane l holding
    sample l of every row; samples past K at alpha 0 and v 0. Forward over
    the tiles: per sample alpha, v, dalpha/dsigma (half delta at sigma ==
    0); a Hillis-Steele product scan of t in each row (shfl_up 1, 2, 4, the
    rows side by side), then the rows in order: T = carry * (1 on lane 0,
    else the exclusive shift), carry times the row's total. Every tile but
    the last is what the kernel keeps in shared memory. Backward over the
    tiles: a reverse scan of the maps s -> alpha v + t s in each row
    (shfl_down 1, 2, 4, a lane combining with lane + off while that is in
    the group), then the rows from the last: S = a + b s_carry with (a, b)
    the exclusive shift (the identity on the last lane), and s_carry
    becoming the row's whole map applied to s_carry."""
    G, PM = composite.BACKWARD_GROUP, composite.BACKWARD_MAX_PER_LANE
    SB, B, K = z.shape
    N, P = SB * B, min(-(-K // G), PM)
    n_t = -(-K // (G * P))
    zr, f = z.reshape(N, K), out.reshape(N, K, 4)
    g, gd, ga = g_rgb.reshape(N, 3), g_depth.reshape(N, 1), \
        g_acc.reshape(N, 1)
    delta = torch.cat([zr[:, 1:], rays.reshape(N, 8)[:, 7:]], 1) - zr
    sigma = f[..., 3]
    e = torch.exp(-delta * sigma.clamp(min=0.0))
    bg = g.sum(-1, keepdim=True) if white_bkgd else torch.zeros(N, 1)
    v = (g[:, :1] * f[..., 0] + g[:, 1:2] * f[..., 1] + g[:, 2:] * f[..., 2]
         + gd * zr + ga - bg)
    dads = torch.where(sigma > 0, delta * e,
                       torch.where(sigma == 0, 0.5 * delta, 0.0))

    def tiles(x):  # (N, K) -> (N, tiles, rows, lanes), zero past K
        return torch.nn.functional.pad(x, (0, n_t * P * G - K)).reshape(
            N, n_t, P, G)

    alpha, v, dads = tiles(1.0 - e), tiles(v), tiles(dads)
    t = (1.0 - alpha) + 1e-10
    lane = torch.arange(G)
    trans, carry = torch.empty(N, n_t, P, G), torch.ones(N, 1)
    for i in range(n_t):
        incl, off = t[:, i], 1
        while off < G:
            up = torch.roll(incl, off, -1)
            incl = torch.where(lane >= off, incl * up, incl)
            off *= 2
        for j in range(P):
            excl = torch.where(lane == 0, 1.0, torch.roll(incl[:, j], 1, -1))
            trans[:, i, j] = carry * excl
            carry = carry * incl[:, j, G - 1:]
    g_sigma, s_carry = torch.empty(N, n_t, P, G), torch.zeros(N, 1)
    for i in reversed(range(n_t)):
        a, b, off = alpha[:, i] * v[:, i], t[:, i], 1
        while off < G:
            a2, b2 = torch.roll(a, -off, -1), torch.roll(b, -off, -1)
            keep = lane + off < G
            a, b = torch.where(keep, a + b * a2, a), \
                torch.where(keep, b * b2, b)
            off *= 2
        for j in reversed(range(P)):
            ae = torch.where(lane == G - 1, 0.0, torch.roll(a[:, j], -1, -1))
            be = torch.where(lane == G - 1, 1.0, torch.roll(b[:, j], -1, -1))
            S = ae + be * s_carry
            g_sigma[:, i, j] = trans[:, i, j] * (v[:, i, j] - S) * dads[:, i, j]
            s_carry = a[:, j, :1] + b[:, j, :1] * s_carry
    w = (alpha * trans).reshape(N, -1)[:, :K]
    g_sigma = g_sigma.reshape(N, -1)[:, :K]
    return torch.cat([w[..., None] * g[:, None], g_sigma[..., None]],
                     -1).reshape(SB, B * K, 4)


# K4 backward's cases: below, at and above one row of 8 samples; the
# plateau configs' 24 and the DTU and FaceScape configs' 40; odd (a partial
# last row); at the register cap (8 rows of 8), just above it (two tiles,
# the first in shared memory), and 1024 (16 tiles)
BACKWARD_KS = (1, 5, 8, 24, 32, 37, 40, 64, 65, 1024)


@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("K", BACKWARD_KS)
def test_composite_backward_kernel_arithmetic_matches_plain(K, white):
    """K4's backward in its kernel's order of operations against autograd
    through the plain version on the CPU, within 1e-5 + 1e-4 |plain| (the
    tolerance chip_smoke.py holds the kernel to), at BACKWARD_KS, SB = 2
    and B = 101 (B = 5 at K = 1024), with about one sigma in 8 exactly 0.
    The plain version's gradient and the model's also agree with a float64
    autograd within 1e-6."""
    assert composite.BACKWARD_GROUP * composite.BACKWARD_MAX_PER_LANE == 64
    inputs = [_t(x) for x in composite_grad_inputs(K, 2, 5 if K > 65 else
                                                   101, K)]
    got = composite_backward_kernel_model(*inputs, white)
    ref = composite_rays_backward_plain(*inputs, white)
    assert ((got - ref).abs() <= 1e-5 + 1e-4 * ref.abs()).all()
    ref64 = composite_rays_backward_plain(*(x.double() for x in inputs),
                                          white)
    assert (got.double() - ref64).abs().max() <= 1e-6
    assert (ref.double() - ref64).abs().max() <= 1e-6


def test_composite_backward_geometry_and_function_on_cpu(monkeypatch):
    """The backward's launch geometry (8 lanes a ray, 16 rays in a block of
    128 threads, no shared memory up to 64 samples; above, 16 bytes of
    shared memory a sample of every tile but the last, in blocks of 64
    threads where 128 do not fit; refused for K < 1, past
    BACKWARD_MAX_K and past the grid), and CompositeFunction's plumbing
    with the launches replaced by the plain versions (the kernels run only
    on the card): the field's gradient is autograd's, rays and z get none,
    and the Function is not used where no gradient is wanted (no_grad,
    inference mode)."""
    geometry = composite.backward_geometry
    assert geometry(4 * 4096, 40) == (1024, 128, 0)
    assert geometry(2 * 1001, 37) == (126, 128, 0)
    assert geometry(0, 8) == (0, 128, 0)
    assert geometry(33, 64) == (3, 128, 0)
    assert geometry(33, 65) == (3, 128, 128 * 8 * 16)
    assert geometry(10, 960) == (1, 128, 128 * 14 * 8 * 16)
    assert geometry(10, 961) == (2, 64, 64 * 15 * 8 * 16)
    assert geometry(10, 1024) == (2, 64, 64 * 15 * 8 * 16)
    assert composite.BACKWARD_MAX_K == 1024
    for K in range(1, composite.BACKWARD_MAX_K + 1):
        _, threads, shared = geometry(1, K)
        assert threads in (128, 64) and shared <= MAX_SHARED_BYTES
    for bad in ((16, 0), (16, composite.BACKWARD_MAX_K + 1), (2 ** 36, 32)):
        with pytest.raises(ValueError):
            geometry(*bad)
    calls = []
    monkeypatch.setattr(composite, "_launch_forward", lambda *a: (
        calls.append("fwd"), composite_rays_plain(*a))[1])
    monkeypatch.setattr(composite, "_launch_backward", lambda *a: (
        calls.append("bwd"), composite_rays_backward_plain(*a))[1])
    rays, z, out, g_rgb, g_d, g_a = (_t(x) for x in
                                     composite_grad_inputs(2, 2, 9, 7))
    for white in (False, True):
        leaf = out.clone().requires_grad_(True)
        res = composite.CompositeFunction.apply(rays, z, leaf, white)
        torch.autograd.backward(res, (g_rgb, g_d, g_a))
        assert torch.equal(leaf.grad, composite_rays_backward_plain(
            rays, z, out, g_rgb, g_d, g_a, white))
        rgb_only = out.clone().requires_grad_(True)
        composite.CompositeFunction.apply(rays, z, rgb_only,
                                          white)[0].sum().backward()
        assert torch.equal(rgb_only.grad, composite_rays_backward_plain(
            rays, z, out, torch.ones_like(g_rgb), torch.zeros_like(g_d),
            torch.zeros_like(g_a), white))
    assert calls == ["fwd", "bwd"] * 4
    with torch.inference_mode():
        res = composite.CompositeFunction.apply(rays, z, out, False)
    assert all(torch.equal(a, b) for a, b in
               zip(res, composite_rays_plain(rays, z, out)))


def test_kernel_wrappers_reject_bad_inputs():
    a, vals, z, hs = (_t(x) for x in k1_inputs(1, 4, 8, 10))
    with pytest.raises(TypeError):
        likelihood_from_anchors(a.long(), vals, z, hs, 0.5)
    with pytest.raises(ValueError):
        likelihood_from_anchors(a, vals, z[:, :5], hs, 0.5)
    with pytest.raises(TypeError):
        remap_anchors(a, vals.double())
    with pytest.raises(ValueError):
        remap_anchors(a[:2], vals)
    z, scal, vals = (_t(x) for x in chord_inputs(1, 1, 2, 3, 10, 8))
    with pytest.raises(TypeError):
        likelihood_from_chord(z.double(), scal, vals, 8, 0.05)
    with pytest.raises(ValueError):     # n_anchors is not vals' A
        likelihood_from_chord(z, scal, vals, 16, 0.05)
    with pytest.raises(ValueError):
        likelihood_from_chord(z[:, :2], scal, vals, 8, 0.05)
    rays, z, out = (_t(x) for x in composite_inputs(1, 1, 4, 3))
    with pytest.raises(TypeError):
        composite_rays(rays, z, out.double())
    with pytest.raises(ValueError):
        composite_rays(rays, z, out[:, :6])
    with pytest.raises(ValueError):
        composite_rays(rays[:, :2], z, out)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_likelihood_kernel_matches_plain_on_card(cuda):
    """Kernel vs plain version on the card, G not a multiple of anything:
    bitwise selection; p within 2e-6 (erff vs torch.erf)."""
    a, vals, z, hs = (_t(x).to(cuda) for x in k1_inputs(3, 257, 256, 1000))
    before = KERNELS["likelihood_from_anchors"].launches
    p, sel = likelihood_from_anchors(a, vals, z, hs, 0.5,
                                     return_selected=True)
    p_ref, sel_ref = likelihood_from_anchors_plain(a, vals, z, hs, 0.5,
                                                   return_selected=True)
    torch.cuda.synchronize()
    assert KERNELS["likelihood_from_anchors"].launches == before + 1
    assert torch.equal(sel, sel_ref)
    assert (p > 0).any()
    assert (p - p_ref).abs().max().item() <= 2e-6


@pytest.mark.cuda
def test_remap_kernel_matches_plain_on_card(cuda):
    rng = np.random.RandomState(4)
    vals = _t(rng.rand(300, 2, 256).astype(np.float32)).to(cuda)
    a = _t(np.sort(rng.randint(0, 256, (300, 32)), -1).astype(np.int32)
           ).to(cuda)
    before = KERNELS["remap_anchors"].launches
    out = remap_anchors(a, vals)
    assert KERNELS["remap_anchors"].launches == before + 1
    assert torch.equal(out, remap_anchors_plain(a, vals))


@pytest.mark.cuda
def test_chord_kernel_matches_plain_on_card(cuda):
    """Kernel vs plain version on the card, NR and NC not multiples of the
    block: bitwise anchor ids; p within 2e-6 (erff vs torch.erf)."""
    z, scal, vals = (_t(x).to(cuda)
                     for x in chord_inputs(7, 2, 3, 37, 1000, 256))
    before = KERNELS["likelihood_from_chord"].launches
    p, ids = likelihood_from_chord(z, scal, vals, 256, 0.05, return_ids=True)
    p_ref, ids_ref = likelihood_from_chord_plain(z, scal, vals, 256, 0.05,
                                                 return_ids=True)
    torch.cuda.synchronize()
    assert KERNELS["likelihood_from_chord"].launches == before + 1
    assert torch.equal(ids, ids_ref)
    assert (p > 0).any()
    assert (p - p_ref).abs().max().item() <= 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("NV,A", [(1, 8), (1, 1024), (3, 8), (3, 1024)])
def test_chord_kernel_ragged_on_card(cuda, NV, A):
    """Kernel vs plain version on the card at NC = 997 (scalar z, p and ids),
    SB = 2, with std and cos at the gates' edges: bitwise ids; p within 2e-6
    and NaN where the plain version's p is NaN."""
    z, scal, vals = chord_inputs(13, 2, NV, 37, 997, A)
    z, scal, vals = (_t(x).to(cuda)
                     for x in (z, scal, with_edge_cases(vals, A)))
    before = KERNELS["likelihood_from_chord"].launches
    p, ids = likelihood_from_chord(z, scal, vals, A, 0.05, return_ids=True)
    p_ref, ids_ref = likelihood_from_chord_plain(z, scal, vals, A, 0.05,
                                                 return_ids=True)
    torch.cuda.synchronize()
    assert KERNELS["likelihood_from_chord"].launches == before + 1
    assert torch.equal(ids, ids_ref)
    assert max_abs_diff(p, p_ref) <= 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("NS", [7, 32, 45])
@pytest.mark.parametrize("C", [1, 5])
@pytest.mark.parametrize("K", [6, 256])
def test_remap_kernel_ragged_on_card(cuda, NS, C, K):
    """Bitwise on the card with NS below, at and above a warp, C > 1, K not
    a multiple of 4 and G = 1001, whose outputs do not fill the last
    block's threads."""
    rng = np.random.RandomState(NS * C + K)
    G = 1001
    assert G * C * NS % remap.launch_geometry(G, C, NS)[1] != 0
    vals = _t(rng.rand(G, C, K).astype(np.float32)).to(cuda)
    a = _t(np.sort(rng.randint(0, K, (G, NS)), -1).astype(np.int32)).to(cuda)
    before = KERNELS["remap_anchors"].launches
    out = remap_anchors(a, vals)
    assert KERNELS["remap_anchors"].launches == before + 1
    assert torch.equal(out, remap_anchors_plain(a, vals))


@pytest.mark.cuda
@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("K", [1, 5, 32, 37, 40, 64])
def test_composite_kernel_matches_plain_on_card(cuda, K, white):
    """Kernel vs plain version on the card at the CPU model's shapes: K
    below, at and above a 32-sample tile (its carry) and odd (scalar z
    loads), SB = 2 and B = 1001 rays (a partial last block): within 1e-5 +
    1e-5 |plain| (the group scan and sums take the products and sums in
    another order). The first row alone (1001 rays: a group past the last
    ray in the last warp) and the same inputs at addresses off the 16-byte
    grain give the same result. z that requires grad is refused."""
    rays, z, out = (_t(x).to(cuda) for x in composite_inputs(K, 2, 1001, K))
    before = KERNELS["composite_rays"].launches
    got = composite_rays(rays, z, out, white)
    ref = composite_rays_plain(rays, z, out, white)
    torch.cuda.synchronize()
    assert KERNELS["composite_rays"].launches == before + 1
    for g, r in zip(got, ref):
        assert ((g - r).abs() <= 1e-5 + 1e-5 * r.abs()).all()
    z_off, out_off = (torch.empty(t.numel() + 1, device=cuda)[1:]
                      .view_as(t).copy_(t) for t in (z, out))
    assert z_off.data_ptr() % 16 and out_off.data_ptr() % 16
    for g, r in zip(composite_rays(rays[:1], z[:1], out[:1], white), got):
        assert torch.equal(g, r[:1])
    for g, r in zip(composite_rays(rays, z_off, out_off, white), got):
        assert torch.equal(g, r)
    with pytest.raises(RuntimeError, match="field_out only"):
        composite_rays(rays, z.requires_grad_(True), out, white)


@pytest.mark.cuda
@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("K", BACKWARD_KS)
def test_composite_backward_kernel_matches_plain_on_card(cuda, K, white):
    """K4's backward kernel vs autograd through the plain version on the
    card, at the CPU model's K (one tile in registers up to 64, tiles in
    shared memory above), SB = 2 and B = 1001 rays (a partial last
    block), about one sigma in 8 exactly 0: within 1e-5 + 1e-4 |plain|
    (the scans take the products and sums in another order). Through
    composite_rays with a field that requires grad, one forward and one
    backward launch give the kernel's gradient bitwise; a field at an
    address off the 16-byte grain gives the same gradient."""
    inputs = [_t(x).to(cuda) for x in composite_grad_inputs(K, 2, 1001, K)]
    before = KERNELS["composite_rays_backward"].launches
    got = composite_rays_backward(*inputs, white)
    ref = composite_rays_backward_plain(*inputs, white)
    torch.cuda.synchronize()
    assert KERNELS["composite_rays_backward"].launches == before + 1
    assert ((got - ref).abs() <= 1e-5 + 1e-4 * ref.abs()).all()
    rays, z, out, g_rgb, g_d, g_a = inputs
    counts = (KERNELS["composite_rays"].launches,
              KERNELS["composite_rays_backward"].launches)
    leaf = out.clone().requires_grad_(True)
    torch.autograd.backward(composite_rays(rays, z, leaf, white),
                            (g_rgb, g_d, g_a))
    assert (KERNELS["composite_rays"].launches,
            KERNELS["composite_rays_backward"].launches) == (
        counts[0] + 1, counts[1] + 1)
    assert torch.equal(leaf.grad, got)
    out_off = torch.empty(out.numel() + 1, device=cuda)[1:].view_as(
        out).copy_(out)
    assert out_off.data_ptr() % 16
    assert torch.equal(composite_rays_backward(rays, z, out_off, g_rgb, g_d,
                                               g_a, white), got)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_prints_no_result_without_cuda(tmp_path, where):
    """chip_smoke.py exits nonzero and prints no result when no CUDA device
    is visible, from the repo and from a directory that holds nothing else
    of the repo."""
    script = REPO / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path))
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
