"""diner_tpu_torch's renderer, DINER.render_batch and RenderServer against
diner_tpu on the CPU, and the device rule of the port's entry points.

End to end: the trained fixture (tests/fixtures/fastpath_tiny.npz) renders
the held-out scene of tests/test_fastpath_regression.py at 64x80 through
both packages, fed the same draws (the JAX renderer's key splits,
renderer.py:74 and depth_guided.py:488, rebuilt here). Gates:
- exact f32: PSNR of port vs JAX >= 40 dB and |dPSNR-vs-GT| <= 0.05 dB;
- fast (anchors + quad int8 latent + bf16): |dPSNR-vs-GT| <= 0.1 dB vs the
  JAX fast render;
- the fast render on the chord likelihood route (K3) vs the default route
  (K1), in the port with the same draws: >= 40 dB apart and |dPSNR-vs-GT|
  <= 0.1 dB (the JAX package's chord route needs the TPU, so it has no CPU
  counterpart at this level).
Measured on the CPU when written: exact 111.7 dB port vs JAX, dPSNR 0.000
dB; fast dPSNR -0.005 dB, paired -0.004 dB (65 dB port vs JAX: bf16
rounds at other places in the two frameworks).
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diner_tpu.core.types import RenderConfig as JRenderConfig
from diner_tpu.data import SyntheticSphereDataset as JDataset
from diner_tpu.data import collate as j_collate
from diner_tpu.data import to_device_batch
from diner_tpu.models import PixelNeRF as JPixelNeRF
from diner_tpu.models.diner import DINER as JDINER
from diner_tpu.renderer.composite import composite_outputs as j_composite
from diner_tpu.renderer.pallas_composite import composite_pallas
from diner_tpu_torch.core import RenderConfig
from diner_tpu_torch.kernels import composite_rays
from diner_tpu_torch.data import SyntheticSphereDataset, collate
from diner_tpu_torch.models import DINER, PixelNeRF, from_jax
from diner_tpu_torch.renderer import composite_outputs, render_image
from diner_tpu_torch.serve import RenderServer

FIXTURE = Path(__file__).parent / "fixtures" / "fastpath_tiny.npz"
H, W = 64, 80


def _psnr(a, b):
    return float(-10.0 * np.log10(np.mean((a - b) ** 2)))


def test_composite_matches_jax():
    rng = np.random.RandomState(0)
    z = np.sort(rng.uniform(1.0, 3.0, (2, 30, 12)), -1).astype(np.float32)
    rays = np.zeros((2, 30, 8), np.float32)
    rays[..., 5], rays[..., 6], rays[..., 7] = 1.0, 1.0, 3.5
    out = rng.randn(2, 30 * 12, 4).astype(np.float32)
    for white in (False, True):
        ref = j_composite(jnp.asarray(rays), jnp.asarray(z),
                          jnp.asarray(out), white)
        got = composite_outputs(torch.from_numpy(rays), torch.from_numpy(z),
                                torch.from_numpy(out), white)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


@pytest.mark.parametrize("white", [False, True])
def test_composite_rays_matches_jax_kernel(white):
    """K4's plain version vs the JAX package's Pallas kernel in interpret
    mode and its XLA composite, B = 45 rays (not a multiple of 32 or of the
    Pallas block), K = 12: rtol 1e-5, atol 1e-6 (float32 products and sums
    in another order)."""
    rng = np.random.RandomState(1)
    SB, B, K = 2, 45, 12
    z = np.sort(rng.uniform(1.0, 3.0, (SB, B, K)), -1).astype(np.float32)
    rays = np.zeros((SB, B, 8), np.float32)
    rays[..., 5], rays[..., 6], rays[..., 7] = 1.0, 1.0, 3.5
    out = rng.randn(SB, B * K, 4).astype(np.float32)
    got = composite_rays(torch.from_numpy(rays), torch.from_numpy(z),
                         torch.from_numpy(out), white)
    ref = composite_pallas(jnp.asarray(rays), jnp.asarray(z),
                           jnp.asarray(out.reshape(SB, B, K, 4)), white,
                           block=16, interpret=True)
    weights, rgb, depth = j_composite(jnp.asarray(rays), jnp.asarray(z),
                                      jnp.asarray(out), white)
    xla = (rgb, depth, jnp.sum(weights, axis=-1))
    for g, r, x in zip(got, ref, xla):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=1e-5,
                                   atol=1e-6)


def _fixture_params():
    data = np.load(FIXTURE)
    meta = json.loads(str(data["__meta__"]))
    params = {}
    for key in data.files:
        if key == "__meta__":
            continue
        node = params
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key].astype(np.float32)
    return params, meta


def test_from_jax_takes_flat_and_nested_trees():
    """The fixture's flat "a/b/c" keys and its nested tree give the same
    state_dict, which loads strictly into the port's DINER."""
    params, meta = _fixture_params()
    data = np.load(FIXTURE)
    flat = {k: data[k].astype(np.float32) for k in data.files
            if k != "__meta__"}
    sd_flat, sd_nested = from_jax(flat), from_jax(params)
    assert sd_flat.keys() == sd_nested.keys()
    assert all(torch.equal(sd_flat[k], sd_nested[k]) for k in sd_flat)
    DINER(PixelNeRF(**meta["model_kw"])).load_state_dict(sd_flat)


FAST = dict(compute_dtype="bfloat16", quad_latent=True, latent_quant="int8")
PATHS = {
    "exact_f32": ({}, dict(n_prior_anchors=0)),
    "fast": (FAST, dict(n_prior_anchors=96)),
    "fast_paired": (FAST, dict(n_prior_anchors=96, paired_prior_gather=True)),
}


@pytest.fixture(scope="module")
def renders():
    """{path: (port rgb, JAX rgb)} and the GT image."""
    params, meta = _fixture_params()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    batch = to_device_batch(j_collate([JDataset(
        n_scenes=1, n_views=meta["data_kw"]["n_views"], H=H, W=W,
        seed=777)[0]]))
    key = jax.random.PRNGKey(0)
    out = {}
    for name, (mkw, rkw) in PATHS.items():
        mkw = dict(meta["model_kw"], **mkw)
        rkw = dict(meta["render_kw"], **rkw)
        jm = JDINER(nerf=JPixelNeRF(**mkw), render_cfg=JRenderConfig(**rkw),
                    znear=meta["znear"], zfar=meta["zfar"])
        rgb_j, _ = jax.jit(lambda v, b, r, m=jm: m.apply(
            v, b, r, method="render_batch"))(
                {"params": jparams}, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, key)

        cfg = RenderConfig(**rkw)
        chunk = cfg.eval_chunk_rays
        noise = []
        for k in jax.random.split(key, -(-H * W // chunk)):
            ks, kg, kf = jax.random.split(k, 3)
            noise.append(tuple(torch.from_numpy(np.array(x)) for x in (
                jax.random.uniform(ks, (1, chunk, cfg.n_depth_candidates)),
                jax.random.normal(kg, (1, chunk, cfg.n_gaussian)),
                jax.random.uniform(kf, (1, chunk, cfg.n_samples)))))
        tm = DINER(PixelNeRF(**mkw), cfg, znear=meta["znear"],
                   zfar=meta["zfar"])
        tm.load_state_dict(from_jax(params))
        rgb_t, depth_t = tm.render_batch(batch, noise=noise, device="cpu")
        assert rgb_t.shape == (1, H, W, 3) and depth_t.shape == (1, H, W)
        out[name] = (np.clip(rgb_t.numpy(), 0, 1),
                     np.clip(np.asarray(rgb_j), 0, 1))
        if name == "fast":   # the same render on the chord route
            tm.render_cfg = dataclasses.replace(cfg, likelihood="chord")
            rgb_c, _ = tm.render_batch(batch, noise=noise, device="cpu")
            out["fast_chord"] = (np.clip(rgb_c.numpy(), 0, 1),
                                 out["fast"][0])
    return out, batch["target_rgb"]


def test_render_exact_f32_matches_jax(renders):
    out, gt = renders
    port, ref = out["exact_f32"]
    assert _psnr(ref, gt) > 20.0, "fixture renders garbage"
    assert _psnr(port, ref) >= 40.0
    assert abs(_psnr(port, gt) - _psnr(ref, gt)) <= 0.05


@pytest.mark.parametrize("path", ["fast", "fast_paired"])
def test_render_fast_matches_jax_in_psnr(renders, path):
    out, gt = renders
    port, ref = out[path]
    assert abs(_psnr(port, gt) - _psnr(ref, gt)) <= 0.1


def test_render_chord_route_matches_default_route(renders):
    """Measured on the CPU when written: the chord route's render equals
    the default route's (PSNR inf), since no anchor id flipped where it
    changed the top-k candidates."""
    out, gt = renders
    chord, v1 = out["fast_chord"]
    assert _psnr(chord, v1) >= 40.0
    assert abs(_psnr(chord, gt) - _psnr(v1, gt)) <= 0.1


def _small_server(**kw):
    model = PixelNeRF(encoder_layers=2, encoder_norm="group",
                      image_padding=4, padding_pe=2, n_blocks=2, d_hidden=32,
                      combine_layer=1, compute_dtype="bfloat16",
                      quad_latent=True, latent_quant="int8")
    cfg = RenderConfig(n_samples=6, n_depth_candidates=32, n_gaussian=2,
                       n_prior_anchors=8, paired_prior_gather=True)
    return RenderServer(model, cfg, znear=SyntheticSphereDataset.znear,
                        zfar=SyntheticSphereDataset.zfar,
                        buckets=((24, 32),), chunk=256, **kw)


def test_render_server_on_cpu():
    server = _small_server(device="cpu")
    b = collate([SyntheticSphereDataset(n_scenes=1, n_views=2, H=24,
                                        W=32)[0]])
    server.load_scene("s0", b["src_rgbs"], b["src_depths"],
                      b["src_depth_stds"], b["src_extrinsics"],
                      b["src_intrinsics"])
    assert server.scene_ids() == ["s0"]
    rgb, depth = server.render("s0", b["target_extrinsics"],
                               b["target_intrinsics"], 24, 32, seed=3)
    assert rgb.shape == (1, 24, 32, 3) and depth.shape == (1, 24, 32)
    assert torch.isfinite(rgb).all() and rgb.min() >= 0 and rgb.max() <= 1
    rgb2, _ = server.render("s0", b["target_extrinsics"],
                            b["target_intrinsics"], 24, 32, seed=3)
    assert torch.equal(rgb, rgb2)  # seeded draws: reproducible requests
    with pytest.raises(ValueError):  # not a bucket
        server.render("s0", b["target_extrinsics"], b["target_intrinsics"],
                      32, 32)
    with pytest.raises(ValueError):  # not loaded
        server.render("s1", b["target_extrinsics"], b["target_intrinsics"],
                      24, 32)
    assert server.unload_scene("s0") and not server.unload_scene("s0")


def test_entry_points_refuse_to_run_without_cuda(monkeypatch):
    """RenderServer, DINER.render_batch and render_image default to CUDA
    and raise without it; device="cpu" is the caller's explicit choice."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _small_server()
    b = collate([SyntheticSphereDataset(n_scenes=1, n_views=2, H=8,
                                        W=8)[0]])
    model = DINER(_small_server(device="cpu").model, RenderConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.render_batch(b)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render_image(None, torch.zeros(1, 2, 2, 8), None, RenderConfig())
