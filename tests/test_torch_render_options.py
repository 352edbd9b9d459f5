"""diner_tpu_torch's render options against diner_tpu on the CPU: the
latent-fetch variants end to end, the pipelined renderer
(render_image(split=...)), ray-sharded rendering (renderer/sharded.py) and
`cli/render_eval --shard-rays`.

Every comparison feeds both packages the same draws, rebuilt from the JAX
renderer's key splits (renderer.py:74, depth_guided.py:488; for a shard,
sharded.py:40's fold_in first). Gates:
- the trained fixture (tests/fixtures/fastpath_tiny.npz) renders its
  held-out scene at 32x40 on the turbo path (latent_anchors 8, bf16 quad
  latent), a stride-2 bf16 quad path and a unique-cells int8 quad path (K
  6): |dPSNR-vs-GT| <= 0.1 dB against the JAX render (bf16 rounds at other
  places in the two frameworks, as on the fast path of
  test_torch_render.py);
- the pipelined render equals the sequential one bit for bit on the CPU
  (the same ops in the same order), with and without the anchors, at chunk
  7 (a tail) and 24 (one chunk), and, with the anchors at chunk 7, JAX's
  pipelined render within 1e-4 (float32 sums in other orders);
- the sharded render over four CPU shards equals JAX's over a 4-device mesh
  within 1e-4, and the port's sequential render of each shard's rays with
  its draws bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_render import FIXTURE, _fixture_params, _psnr

from diner_tpu.core.types import RenderConfig as JRenderConfig
from diner_tpu.data import SyntheticSphereDataset as JDataset
from diner_tpu.data import collate as j_collate
from diner_tpu.data import to_device_batch
from diner_tpu.geometry import gen_rays as j_gen_rays
from diner_tpu.models import PixelNeRF as JPixelNeRF
from diner_tpu.models.diner import DINER as JDINER
from diner_tpu.parallel import make_mesh
from diner_tpu.renderer import render_image as j_render_image
from diner_tpu.renderer.sharded import (
    render_image_sharded as j_render_image_sharded)
from diner_tpu_torch.core import RenderConfig
from diner_tpu_torch.geometry import gen_rays
from diner_tpu_torch.models import DINER, PixelNeRF, from_jax
from diner_tpu_torch.models import pixelnerf as tpn
from diner_tpu_torch.renderer import render_image, render_image_sharded
from diner_tpu_torch.renderer.sharded import shard_rays
from diner_tpu_torch.serve import RenderServer

H, W = 32, 40
BF16_QUAD = dict(compute_dtype="bfloat16", quad_latent=True)
VARIANTS = {
    "turbo": dict(BF16_QUAD, latent_anchors=8),
    "stride2": dict(BF16_QUAD, latent_sample_stride=2),
    "unique6": dict(BF16_QUAD, latent_quant="int8", latent_unique_cells=6),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small ops: one intra-op thread runs them fastest under the Tier-1
    command's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the small scene's renderer: few candidates and samples keep JAX's compiles
# short
SMALL_RENDER = dict(n_samples=8, n_depth_candidates=32, n_gaussian=3)


def _jax_draws(key, n_chunks: int, chunk: int, cfg, SB: int = 1):
    """The per-chunk noise of JAX's render_flat_chunked from `key`."""
    noise = []
    for k in jax.random.split(key, n_chunks):
        ks, kg, kf = jax.random.split(k, 3)
        noise.append(tuple(torch.from_numpy(np.array(x)) for x in (
            jax.random.uniform(ks, (SB, chunk, cfg.n_depth_candidates)),
            jax.random.normal(kg, (SB, chunk, cfg.n_gaussian)),
            jax.random.uniform(kf, (SB, chunk, cfg.n_samples)))))
    return noise


@pytest.fixture(scope="module")
def variant_renders():
    """{variant: (port rgb, JAX rgb)} of the held-out scene, and the GT."""
    params, meta = _fixture_params()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    batch = to_device_batch(j_collate([JDataset(
        n_scenes=1, n_views=meta["data_kw"]["n_views"], H=H, W=W,
        seed=777)[0]]))
    rkw = dict(meta["render_kw"], n_prior_anchors=96, eval_chunk_rays=H * W)
    cfg = RenderConfig(**rkw)
    chunk = cfg.eval_chunk_rays
    key = jax.random.PRNGKey(0)
    noise = _jax_draws(key, -(-H * W // chunk), chunk, cfg)
    sd = from_jax(params)
    out = {}
    for name, knobs in VARIANTS.items():
        mkw = dict(meta["model_kw"], **knobs)
        jm = JDINER(nerf=JPixelNeRF(**mkw), render_cfg=JRenderConfig(**rkw),
                    znear=meta["znear"], zfar=meta["zfar"])
        rgb_j, _ = jax.jit(lambda v, b, r, m=jm: m.apply(
            v, b, r, method="render_batch"))(
                {"params": jparams}, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, key)
        tm = DINER(PixelNeRF(**mkw), cfg, znear=meta["znear"],
                   zfar=meta["zfar"])
        tm.load_state_dict(sd)
        rgb_t, _ = tm.render_batch(batch, noise=noise, device="cpu")
        out[name] = (np.clip(rgb_t.numpy(), 0, 1),
                     np.clip(np.asarray(rgb_j), 0, 1))
    return out, batch["target_rgb"]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_render_matches_jax_in_psnr(variant_renders, variant):
    out, gt = variant_renders
    port, ref = out[variant]
    assert _psnr(ref, gt) > 20.0, "fixture renders garbage"
    assert abs(_psnr(port, gt) - _psnr(ref, gt)) <= 0.1


@pytest.fixture(scope="module")
def small_scene():
    """The fixture's model in both packages and a 6x4 view (24 rays) of a
    synthetic scene: (JAX model, params, encoding, rays; port model,
    encoding, rays, config kwargs)."""
    params, meta = _fixture_params()
    jparams = {"params": jax.tree_util.tree_map(jnp.asarray,
                                                 params["nerf"])}
    jm = JPixelNeRF(**meta["model_kw"])
    tm = PixelNeRF(**meta["model_kw"]).eval()
    tm.load_state_dict({k[len("nerf."):]: v
                        for k, v in from_jax(params).items()})
    b = j_collate([JDataset(n_scenes=1, n_views=2, H=4, W=6, seed=3)[0]])
    keys = ("src_rgbs", "src_depths", "src_depth_stds", "src_extrinsics",
            "src_intrinsics")
    jenc = jax.jit(lambda v, *a: jm.apply(v, *a, method="encode"))(
        jparams, *(jnp.asarray(b[k]) for k in keys))
    with torch.no_grad():
        tenc = tm.encode(*(torch.from_numpy(np.asarray(b[k])) for k in keys))
    z = (meta["znear"], meta["zfar"])
    jrays = j_gen_rays(jnp.asarray(b["target_extrinsics"]),
                       jnp.asarray(b["target_intrinsics"]), 6, 4, *z)
    trays = gen_rays(torch.from_numpy(b["target_extrinsics"]),
                     torch.from_numpy(b["target_intrinsics"]), 6, 4, *z)
    return dict(jm=jm, jparams=jparams, jenc=jenc, jrays=jrays, tm=tm,
                tenc=tenc, trays=trays)


@pytest.mark.parametrize("anchors", [0, 8])
def test_pipelined_render_equals_sequential_and_jax(small_scene, anchors):
    """Port pipelined vs port sequential at chunk 7 and 24; with the
    anchors at chunk 7 also against JAX's pipelined render (one compile)."""
    s = small_scene
    rkw = dict(SMALL_RENDER, n_prior_anchors=anchors, anchor_field_depth=True)
    cfg = RenderConfig(**rkw)
    tm, tenc = s["tm"], s["tenc"]
    key = jax.random.PRNGKey(2)
    split = (lambda p, aux: tm.field_gather(tenc, p, aux),
             lambda g, p, d: tm.field_mlp(tenc, g, p, d))
    for chunk in (7, 24):
        noise = _jax_draws(key, -(-24 // chunk), chunk, cfg)
        seq = render_image(lambda p, d, aux: tm.field(tenc, p, d, aux),
                           s["trays"], tenc, cfg, chunk=chunk, noise=noise,
                           device="cpu")
        pip = render_image(None, s["trays"], tenc, cfg, chunk=chunk,
                           noise=noise, device="cpu", split=split)
        for p, q in zip(pip, seq):
            assert torch.equal(p, q), f"chunk {chunk}"
    if not anchors:
        return
    jm, v, jenc = s["jm"], s["jparams"], s["jenc"]

    def j_render(v, jenc, rays):
        return j_render_image(
            None, key, rays, jenc, JRenderConfig(**rkw), chunk=7,
            split=(lambda p, aux: jm.apply(v, jenc, p, aux,
                                           method="field_gather"),
                   lambda g, p, d: jm.apply(v, jenc, g, p, d,
                                            method="field_mlp")))

    ref = jax.jit(j_render)(v, jenc, s["jrays"])
    noise = _jax_draws(key, 4, 7, cfg)
    pip = render_image(None, s["trays"], tenc, cfg, chunk=7, noise=noise,
                       device="cpu", split=split)
    for p, r in zip(pip, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)


def test_sharded_render_matches_jax_mesh(small_scene):
    """Four shards of 6 rays, chunk 4 (a padded tail in each shard), the
    anchors on: the port over ["cpu"] * 4 against JAX over a 4-device mesh
    of the conftest's virtual CPU devices."""
    s = small_scene
    rkw = dict(SMALL_RENDER, n_prior_anchors=8)
    jcfg, cfg = JRenderConfig(**rkw), RenderConfig(**rkw)
    jm, v, tm = s["jm"], s["jparams"], s["tm"]
    mesh = make_mesh(axis_names=("data",), devices=jax.devices()[:4])

    def j_field(enc, pts, dirs, epi_aux=None):
        return jm.apply(v, enc, pts, dirs, epi_aux, method="field")

    key, chunk, n_shards = jax.random.PRNGKey(5), 4, 4
    per = 24 // n_shards
    noise = [_jax_draws(jax.random.fold_in(key, d), -(-per // chunk), chunk,
                        cfg) for d in range(n_shards)]
    ref = j_render_image_sharded(j_field, key, s["jrays"], s["jenc"], jcfg,
                                 mesh, chunk=chunk)

    def field(enc, p, d, aux=None):
        return tm.field(enc, p, d, aux)

    with torch.no_grad():
        got = render_image_sharded(field, s["trays"], s["tenc"], cfg,
                                   ["cpu"] * n_shards, chunk=chunk,
                                   noise=noise)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == tuple(r.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)
    # each shard alone through render_image with the same draws
    shards = shard_rays(s["trays"], n_shards)
    rgb = torch.cat([render_image(
        lambda p, d, aux: tm.field(s["tenc"], p, d, aux),
        shards[d][:, None], s["tenc"], cfg, chunk=chunk, noise=noise[d],
        device="cpu")[0].reshape(1, per, 3) for d in range(n_shards)], 1)
    assert torch.equal(rgb.reshape(got[0].shape), got[0])


def test_render_eval_shard_rays_on_cpu(tmp_path, capsys):
    """--shard-rays with --device cpu renders unsharded and says so."""
    from diner_tpu_torch.cli import render_eval
    from diner_tpu_torch.cli.build import build_dataset, build_diner
    from diner_tpu_torch.core.config import load_config
    from diner_tpu_torch.train import ckpt_io

    cfg = FIXTURE.parents[2] / "configs" / "train_synthetic.yaml"
    conf = load_config(cfg)
    val_set = build_dataset(conf["data"]["val"], stage="val")
    torch.manual_seed(0)
    model = build_diner(conf, znear=val_set.znear, zfar=val_set.zfar)
    ckpt_io.save(tmp_path / "ckpts", 0, {"nerf": model.nerf.state_dict(),
                                        "step": 0})
    scores = render_eval.main([
        "--config", str(cfg), "--ckpt", str(tmp_path / "ckpts"), "--out",
        str(tmp_path / "out"), "--n", "1", "--shard-rays", "--device",
        "cpu"])
    assert "rendering unsharded on one device (cpu)" in \
        capsys.readouterr().out
    assert all(np.isfinite(v) for v in scores.values())
    # the render function --shard-rays uses with several cards, over two
    # CPU shards: one image of the val set, finite, its shape
    from diner_tpu_torch.data import collate

    model.render_cfg = dataclasses.replace(model.render_cfg,
                                           eval_chunk_rays=256)
    render_fn = render_eval._sharded_render_fn(model,
                                               [torch.device("cpu")] * 2)
    batch = collate([val_set[0]])
    rgb, depth = render_fn(batch, seed=0)
    assert rgb.shape == batch["target_rgb"].shape
    assert depth.shape == batch["target_rgb"].shape[:-1]
    assert np.isfinite(rgb).all() and np.isfinite(depth).all()


def test_preset_with_a_sample_stride_builds_and_renders(tmp_path,
                                                        monkeypatch):
    """A YAML preset setting latent_sample_stride: 2 builds through
    RenderServer.from_preset, and its renders go through the strided
    fetch."""
    conf = {
        "nerf": {"kwargs": {
            "compute_dtype": "bfloat16", "quad_latent": True,
            "latent_sample_stride": 2,
            "encoder_conf": {"kwargs": {"num_layers": 2, "norm": "group",
                                        "image_padding": 4,
                                        "padding_pe": 2}},
            "mlp_fine_conf": {"kwargs": {"n_blocks": 2, "d_hidden": 32,
                                         "combine_layer": 1}}}},
        "renderer": {"kwargs": {"n_samples": 6, "n_depth_candidates": 32,
                                "n_gaussian": 2, "n_prior_anchors": 8,
                                "eval_chunk_rays": 128}},
    }
    (tmp_path / "preset.yaml").write_text(yaml.safe_dump(conf))
    from diner_tpu_torch.data import SyntheticSphereDataset, collate

    torch.manual_seed(0)
    server = RenderServer.from_preset(
        tmp_path / "preset.yaml", None, SyntheticSphereDataset.znear,
        SyntheticSphereDataset.zfar, buckets=((12, 16),), device="cpu")
    assert server.model.latent_sample_stride == 2
    calls = []
    strided = tpn.index_latent_strided
    monkeypatch.setattr(tpn, "index_latent_strided",
                        lambda *a: calls.append(a[2:]) or strided(*a))
    b = collate([SyntheticSphereDataset(n_scenes=1, n_views=2, H=12,
                                        W=16)[0]])
    server.load_scene("s", b["src_rgbs"], b["src_depths"],
                      b["src_depth_stds"], b["src_extrinsics"],
                      b["src_intrinsics"])
    rgb, _ = server.render("s", b["target_extrinsics"],
                           b["target_intrinsics"], 12, 16)
    assert torch.isfinite(rgb).all()
    assert calls == [(128, 2)] * 2   # 192 rays: two chunks, one padded


def test_sharded_render_refuses_cuda_without_it(monkeypatch):
    """render_image_sharded resolves each device as the entry points do: a
    CUDA device without CUDA raises before anything runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render_image_sharded(None, torch.zeros(1, 2, 2, 8), None,
                             RenderConfig(), ["cuda:0", "cuda:0"])
