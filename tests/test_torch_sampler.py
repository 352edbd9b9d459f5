"""diner_tpu_torch's sampler against diner_tpu on the CPU.

Noise: jax.random cannot be reproduced in torch, so the tests rebuild the JAX
sampler's draws by repeating its key splits (depth_guided.py:488) and hand
them to the port. Tolerances are stated at each comparison.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernels import chord_inputs as _chord_inputs
from test_torch_kernels import k1_inputs as _k1_inputs

from diner_tpu.core.types import (RenderConfig as JRenderConfig,
                                  SceneEncoding as JSceneEncoding)
from diner_tpu.data import SyntheticSphereDataset as JDataset
from diner_tpu.data import collate as j_collate
from diner_tpu.geometry import depth2normal as j_depth2normal
from diner_tpu.geometry import gen_rays as j_gen_rays
from diner_tpu.sampler import depth_guided as jdg
from diner_tpu.sampler.pallas_likelihood import (
    likelihood_from_chord as j_likelihood_from_chord)
from diner_tpu_torch.core import RenderConfig, SceneEncoding
from diner_tpu_torch.kernels import (likelihood_from_anchors,
                                     likelihood_from_chord)
from diner_tpu_torch.sampler import depth_guided as tdg


def _t(x):
    return torch.from_numpy(np.array(x))


def test_likelihood_plain_matches_jax_fallback():
    """K1's plain version vs the JAX package's XLA fallback (remap +
    likelihood math, depth_guided.py:405-442), on the inputs of
    tests/test_sampler.py's fused-likelihood case. Both compute the true
    erf; 2e-6 abs covers the ulps between torch's and XLA's float32 erf."""
    a, vals, z, hs = _k1_inputs(11, 13, 16, 120)
    ddm = 0.5
    got = likelihood_from_anchors(_t(a), _t(vals), _t(z), _t(hs), ddm)
    out = np.asarray(jdg._remap_monotone(
        jnp.asarray(vals.transpose(0, 2, 1)), jnp.asarray(a)))
    d, s, c = out[..., 0], out[..., 1], out[..., 2]
    jz, jhs = jnp.asarray(z), jnp.asarray(hs)
    valid = (c <= 0) & (np.abs(d - z) < ddm) & (s != 0)
    safe = jnp.where(s == 0, 1.0, s) * math.sqrt(2.0)
    ref = jnp.where(valid, 0.5 * jnp.abs(
        jax.scipy.special.erf((jz + jhs - d) / safe)
        - jax.scipy.special.erf((jz - jhs - d) / safe)), 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6)


def test_chord_plain_matches_jax_kernel():
    """K3's plain version vs the JAX package's Pallas kernel in interpret
    mode on the same numpy inputs, NR not a multiple of its 8-ray tile. The
    tolerance is the JAX test's own, atol 2e-5 and rtol 1e-3: the TPU kernel
    evaluates erf by the A&S polynomial, the port the true erf."""
    SB, NV, NR, NC, A, ddm = 1, 2, 12, 64, 32, 0.05
    z, scal, vals = _chord_inputs(0, SB, NV, NR, NC, A)
    got = likelihood_from_chord(_t(z), _t(scal), _t(vals), A, ddm).numpy()
    ref = np.asarray(j_likelihood_from_chord(
        jnp.asarray(z), jnp.asarray(scal), jnp.asarray(vals), A, ddm,
        interpret=True))
    assert got.shape == ref.shape == (SB, NV, NR, NC)
    assert (ref > 0).mean() > 0.02
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-3)


# -- the sampler on a synthetic scene ----------------------------------------

def _scene(H=24, W=32, NV=3, NR=50, seed=0):
    """Numpy SceneEncoding fields + rays of a synthetic sphere scene (the
    normals from the JAX package's depth2normal, so that the sampler alone
    is compared)."""
    b = j_collate([JDataset(n_scenes=1, n_views=NV, H=H, W=W,
                            seed=seed)[0]])
    K = b["src_intrinsics"]
    normals = np.asarray(j_depth2normal(
        jnp.asarray(b["src_depths"].reshape(NV, H, W, 1)),
        jnp.asarray(K.reshape(NV, 3, 3)))).reshape(1, NV, H, W, 3)
    rays = np.asarray(j_gen_rays(jnp.asarray(b["target_extrinsics"]),
                                 jnp.asarray(b["target_intrinsics"]), W, H,
                                 1.0, 3.5)).reshape(1, H * W, 8)
    pick = np.random.RandomState(seed).choice(H * W, NR, replace=False)
    fields = dict(depths=b["src_depths"], depth_stds=b["src_depth_stds"],
                  normals=normals, poses=b["src_extrinsics"],
                  focal=K[..., [0, 1], [0, 1]], c=K[..., :2, 2])
    return fields, rays[:, np.sort(pick)]


def _encs(fields):
    lat = np.zeros((1, fields["depths"].shape[1], 2, 2, 1), np.float32)
    j = JSceneEncoding(latent=jnp.asarray(lat),
                       **{k: jnp.asarray(v) for k, v in fields.items()})
    t = SceneEncoding(latent=_t(lat), **{k: _t(v) for k, v in fields.items()})
    return j, t


def _jax_draws(key, SB, NR, cfg):
    """The three draws sample_depthguided makes from `key`."""
    ks, kg, kf = jax.random.split(key, 3)
    return (jax.random.uniform(ks, (SB, NR, cfg.n_depth_candidates)),
            jax.random.normal(kg, (SB, NR, cfg.n_gaussian)),
            jax.random.uniform(kf, (SB, NR, cfg.n_samples)))


BRANCHES = {
    "exact": dict(),
    "stride": dict(prior_stride=4),
    "anchors": dict(n_prior_anchors=64),
    "paired": dict(n_prior_anchors=64, paired_prior_gather=True),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_surface_likelihoods_match_jax(branch):
    """Same candidates through both packages. The anchor branches go through
    K1's plain version here and through the JAX CPU fallback there. p to
    2e-6 abs (erf ulps); the anchor depth table bitwise, also on the paired
    bf16 path."""
    fields, rays = _scene()
    jenc, tenc = _encs(fields)
    z = np.asarray(jdg.sample_stratified(jax.random.PRNGKey(3),
                                         jnp.asarray(rays), 200))
    kw = BRANCHES[branch]
    jp, jo, jaux = jax.jit(lambda r, zz, e: jdg.surface_likelihoods(
        r, zz, e, 0.05, return_aux=True, **kw))(jnp.asarray(rays),
                                                 jnp.asarray(z), jenc)
    tp, to, taux = tdg.surface_likelihoods(_t(rays), _t(z), tenc, 0.05,
                                           return_aux=True, **kw)
    assert float(np.asarray(jp).max()) > 0.01  # the scene is hit
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=2e-6)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-6)
    if "n_prior_anchors" in kw:
        np.testing.assert_array_equal(taux.depth.numpy(),
                                      np.asarray(jaux.depth))
        np.testing.assert_allclose(taux.uv0.numpy(), np.asarray(jaux.uv0),
                                   atol=1e-6)
    else:
        assert taux is None and jaux is None


@pytest.mark.parametrize("branch", ["exact", "anchors"])
def test_sample_depthguided_matches_jax_with_jax_draws(branch):
    """The whole sampler, fed JAX's own draws: z within 1e-5 abs (the
    Gaussian refit's weighted sums in another order)."""
    fields, rays = _scene(seed=1)
    jenc, tenc = _encs(fields)
    cfg_kw = dict(n_samples=16, n_depth_candidates=128, n_gaussian=5,
                  **BRANCHES[branch])
    key = jax.random.PRNGKey(7)
    jz = np.asarray(jax.jit(lambda k, r, e: jdg.sample_depthguided(
        k, r, e, JRenderConfig(**cfg_kw)))(key, jnp.asarray(rays), jenc))
    cfg = RenderConfig(**cfg_kw)
    noise = tuple(_t(x) for x in _jax_draws(key, 1, rays.shape[1], cfg))
    tz = tdg.sample_depthguided(_t(rays), tenc, cfg, noise=noise).numpy()
    assert tz.shape == jz.shape == (1, rays.shape[1], 16)
    np.testing.assert_allclose(tz, jz, atol=1e-5)


def test_sample_depthguided_draws_from_generator():
    fields, rays = _scene(seed=2)
    _, tenc = _encs(fields)
    cfg = RenderConfig(n_samples=8, n_depth_candidates=64, n_gaussian=3,
                       n_prior_anchors=16)
    z1, z2 = (tdg.sample_depthguided(_t(rays), tenc, cfg,
                                     generator=torch.Generator().manual_seed(
                                         5)) for _ in range(2))
    assert torch.equal(z1, z2)
    assert (z1[..., 1:] >= z1[..., :-1]).all()
    assert ((z1 >= 1.0) & (z1 <= 3.5)).all()


def test_chord_route_matches_jax_anchor_path(monkeypatch):
    """surface_likelihoods(likelihood="chord") vs the JAX package's XLA
    anchor path on the same candidates. The chord route reassociates the
    chord parameter (t = (P0 + z P1) inv_dd / zc against the XLA path's
    (P0 + z P1) / (zc dd)), so it may pick the other anchor at an anchor
    boundary: as in tests/test_sampler.py's chord test, candidates whose
    parameter lies within 1e-4 of a boundary between two anchors in any
    view are left out. The rest agree within 2e-5 abs: XLA on the CPU
    rounds z_cam = w0 + z w1 as one fused multiply-add, the port as two
    operations, and one ulp of z_cam (2.4e-7 at 2 m) moves the erf
    arguments by ulp / (sqrt2 std), 1.7e-5 at the scene's std of 0.01."""
    fields, rays = _scene(seed=3)
    jenc, tenc = _encs(fields)
    A, NC = 64, 200
    z = np.asarray(jdg.sample_stratified(jax.random.PRNGKey(5),
                                         jnp.asarray(rays), NC))
    jp, _ = jax.jit(lambda r, zz, e: jdg.surface_likelihoods(
        r, zz, e, 0.05, n_prior_anchors=A))(jnp.asarray(rays),
                                            jnp.asarray(z), jenc)
    seen = {}

    def spy(zz, scal, vals, n_anchors, ddm):
        seen["scal"] = scal.numpy().astype(np.float64)
        return likelihood_from_chord(zz, scal, vals, n_anchors, ddm)

    monkeypatch.setattr(tdg, "likelihood_from_chord", spy)
    tp, _ = tdg.surface_likelihoods(_t(rays), _t(z), tenc, 0.05,
                                    n_prior_anchors=A, likelihood="chord")
    w0, w1, P0, P1, inv_dd, dd_ok = np.moveaxis(seen["scal"][..., :6, None],
                                                3, 0)
    zz = z[:, None].astype(np.float64)
    s = np.where(dd_ok > 0, (P0 + zz * P1) * inv_dd / (w0 + zz * w1), 0.5)
    frac = np.clip(s, 0.0, 1.0) * A
    k = np.round(frac)     # ids 0 and A - 1 extend past the clipped ends
    safe = ((np.abs(frac - k) > 1e-4) | (k < 1) | (k > A - 1)).all(axis=1)
    assert safe.mean() > 0.99 and float(np.asarray(jp).max()) > 0.01
    np.testing.assert_allclose(np.where(safe, tp.numpy(), 0.0),
                               np.where(safe, np.asarray(jp), 0.0), atol=2e-5)


def test_likelihood_route_is_checked():
    with pytest.raises(ValueError, match="likelihood"):
        RenderConfig(likelihood="v2")
    fields, rays = _scene()
    _, tenc = _encs(fields)
    with pytest.raises(ValueError, match="likelihood"):
        tdg.surface_likelihoods(_t(rays), torch.ones(1, rays.shape[1], 8),
                                tenc, 0.05, n_prior_anchors=8,
                                likelihood="v2")
