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

from diner_tpu_torch.kernels import (KERNELS, chord, composite_rays,
                                     composite_rays_plain,
                                     likelihood_from_anchors,
                                     likelihood_from_anchors_plain,
                                     likelihood_from_chord,
                                     likelihood_from_chord_plain, remap,
                                     remap_anchors, remap_anchors_plain)
from diner_tpu_torch.kernels.build import MAX_SHARED_BYTES
from diner_tpu_torch.kernels.cases import (EDGE_STDS, chord_inputs,
                                           max_abs_diff, with_edge_cases)


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


def composite_inputs(seed, SB, B, K):
    """K4 inputs: rays with near 1 and far 3.5, ascending z, field outputs
    with rgb in [0, 1] and sigma of both signs."""
    rng = np.random.RandomState(seed)
    rays = np.zeros((SB, B, 8), np.float32)
    rays[..., 5], rays[..., 6], rays[..., 7] = 1.0, 1.0, 3.5
    z = np.sort(rng.uniform(1.0, 3.5, (SB, B, K)), -1).astype(np.float32)
    out = rng.rand(SB, B * K, 4).astype(np.float32)
    out[..., 3] = rng.randn(SB, B * K) * 4.0
    return rays, z, out


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


def test_composite_refuses_grad_off_the_cpu():
    """The K4 kernel has no backward: off the CPU, inputs that require grad
    raise before any launch (meta tensors stand in for the card here). On
    the CPU the plain version keeps the autograd graph."""
    rays, z, out = (torch.empty(1, 4, 8, device="meta"),
                    torch.empty(1, 4, 3, device="meta"),
                    torch.empty(1, 12, 4, device="meta", requires_grad=True))
    with pytest.raises(RuntimeError, match="no backward"):
        composite_rays(rays, z, out)
    rays, z, out = (_t(x) for x in composite_inputs(1, 1, 4, 3))
    out.requires_grad_(True)
    rgb, _, _ = composite_rays(rays, z, out)
    rgb.sum().backward()
    assert out.grad is not None and torch.isfinite(out.grad).all()


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
def test_composite_kernel_matches_plain_on_card(cuda, white):
    """Kernel vs plain version on the card, with K = 40 (a second, partial
    32-sample tile and its carry) and B = 1001 rays: within 1e-5 + 1e-5
    |plain| (the shuffle scan and the warp sums take the products and sums
    in another order)."""
    rays, z, out = (_t(x).to(cuda) for x in composite_inputs(8, 2, 1001, 40))
    before = KERNELS["composite_rays"].launches
    got = composite_rays(rays, z, out, white)
    ref = composite_rays_plain(rays, z, out, white)
    torch.cuda.synchronize()
    assert KERNELS["composite_rays"].launches == before + 1
    for g, r in zip(got, ref):
        assert ((g - r).abs() <= 1e-5 + 1e-5 * r.abs()).all()
    with pytest.raises(RuntimeError, match="no backward"):
        composite_rays(rays, z, out.requires_grad_(True), white)


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
