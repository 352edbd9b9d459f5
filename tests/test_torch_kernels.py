"""diner_tpu_torch's kernels: the plain versions against a numpy/scipy oracle
on the CPU, the CUDA kernels against their plain versions on the card, and
chip_smoke.py's refusal to print a result without a card.

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

from diner_tpu_torch.kernels import (KERNELS, likelihood_from_anchors,
                                     likelihood_from_anchors_plain,
                                     remap_anchors, remap_anchors_plain)


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
