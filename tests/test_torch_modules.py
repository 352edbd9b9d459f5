"""diner_tpu_torch modules against their diner_tpu counterparts on the CPU.

Inputs come from a numpy seed and go through the JAX function and its port;
weights reach the port through `from_jax`. Tolerances (float32):
- 1e-5 abs for elementwise geometry, gathers, resize and the MLP: the two
  frameworks round sums and transcendental functions at other places, a few
  ulps at these magnitudes;
- 1e-4 abs for the convolution trunk: long conv accumulations in another
  order (oneDNN vs XLA), through up to 33 layers.
Also here: the port's import rule (no JAX, no diner_tpu).
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diner_tpu.geometry import (depth2normal as j_depth2normal,
                                gen_rays as j_gen_rays,
                                project_points as j_project_points,
                                transform_points as j_transform_points)
from diner_tpu.image_ops import resize_bilinear_align_corners as j_resize
from diner_tpu.image_ops.grid_sample import (grid_sample as j_grid_sample,
                                             grid_sample_quad as j_gsq,
                                             pack_quad as j_pack_quad)
from diner_tpu.nn import (ResNetTrunk as JTrunk, ResnetFC as JResnetFC,
                          SpatialEncoder as JSpatialEncoder,
                          posenc as j_posenc)
from diner_tpu_torch.geometry import (depth2normal, gen_rays, project_points,
                                      transform_points)
from diner_tpu_torch.image_ops import (grid_sample, grid_sample_quad,
                                       pack_quad,
                                       resize_bilinear_align_corners)
from diner_tpu_torch.models import from_jax
from diner_tpu_torch.nn import ResNetTrunk, ResnetFC, SpatialEncoder, posenc

REPO = Path(__file__).resolve().parent.parent


def _t(x):
    return torch.from_numpy(np.array(x))


def _cams(rng, B, H, W):
    """Random look-at extrinsics and pinhole intrinsics (B, 4, 4), (B, 3, 3)."""
    ext = np.zeros((B, 4, 4), np.float32)
    for b in range(B):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        ext[b, :3, :3] = q * np.sign(np.linalg.det(q))
        ext[b, :3, 3] = rng.randn(3) * 0.3 + [0.0, 0.0, 2.0]
        ext[b, 3, 3] = 1.0
    K = np.zeros((B, 3, 3), np.float32)
    K[:, 0, 0] = rng.uniform(0.8, 1.2, B) * W
    K[:, 1, 1] = rng.uniform(0.8, 1.2, B) * W
    K[:, 0, 2] = W / 2 + rng.randn(B)
    K[:, 1, 2] = H / 2 + rng.randn(B)
    K[:, 2, 2] = 1.0
    return ext, K


def test_gen_rays_matches_jax():
    rng = np.random.RandomState(0)
    ext, K = _cams(rng, 2, 12, 16)
    ref = np.asarray(j_gen_rays(jnp.asarray(ext), jnp.asarray(K), 16, 12,
                                jnp.asarray([0.5, 1.0]), jnp.asarray([2., 3.])))
    got = gen_rays(_t(ext), _t(K), 16, 12, torch.tensor([0.5, 1.0]),
                   torch.tensor([2.0, 3.0])).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_transform_and_project_match_jax():
    rng = np.random.RandomState(1)
    ext, K = _cams(rng, 3, 10, 14)
    xyz = rng.randn(3, 50, 3).astype(np.float32)
    focal = K[:, [0, 1], [0, 1]]
    c = K[:, :2, 2]
    cam_ref = j_transform_points(jnp.asarray(ext), jnp.asarray(xyz))
    uv_ref = j_project_points(cam_ref, jnp.asarray(focal), jnp.asarray(c),
                              (14, 10))
    cam = transform_points(_t(ext), _t(xyz))
    uv = project_points(cam, _t(focal), _t(c), (14, 10))
    np.testing.assert_allclose(cam.numpy(), np.asarray(cam_ref), atol=1e-5)
    np.testing.assert_allclose(uv.numpy(), np.asarray(uv_ref), atol=1e-5,
                               rtol=1e-5)


def test_depth2normal_with_holes_matches_jax():
    rng = np.random.RandomState(2)
    H, W = 14, 18
    _, K = _cams(rng, 2, H, W)
    depth = (2.0 + 0.3 * rng.rand(2, H, W, 1)).astype(np.float32)
    depth[rng.rand(2, H, W, 1) < 0.15] = 0.0  # invalid pixels -> repair
    ref = np.asarray(j_depth2normal(jnp.asarray(depth), jnp.asarray(K)))
    got = depth2normal(_t(depth), _t(K)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_grid_sample_border_matches_jax(mode):
    rng = np.random.RandomState(3)
    img = rng.randn(2, 3, 9, 11, 5).astype(np.float32)
    uv = rng.uniform(-1.3, 1.3, (2, 3, 40, 2)).astype(np.float32)
    ref = np.asarray(j_grid_sample(jnp.asarray(img), jnp.asarray(uv), mode,
                                   "border"))
    got = grid_sample(_t(img), _t(uv), mode, "border").numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_quad_gather_matches_jax(dtype):
    """pack_quad + grid_sample_quad, on float rows and on int8 rows (the
    quantized latent: the blend promotes to the weights' float32)."""
    rng = np.random.RandomState(4)
    img = rng.randn(2, 8, 10, 6).astype(np.float32)
    if dtype == "int8":
        img = np.clip(np.round(img * 40), -127, 127).astype(np.int8)
    uv = rng.uniform(-1.2, 1.2, (2, 30, 2)).astype(np.float32)
    q_ref = j_pack_quad(jnp.asarray(img))
    q = pack_quad(_t(img))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    ref = np.asarray(j_gsq(q_ref, jnp.asarray(uv)))
    got = grid_sample_quad(q, _t(uv)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_resize_align_corners_matches_jax(dtype):
    """f32 to 1e-5; bf16 with the source grid rounded in bf16 on both sides:
    the result may differ by one bf16 rounding of the blend (2^-8 rel)."""
    rng = np.random.RandomState(5)
    img = rng.randn(2, 7, 9, 3).astype(np.float32)
    ref = np.asarray(j_resize(jnp.asarray(img, dtype), (29, 37))
                     .astype(jnp.float32))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = resize_bilinear_align_corners(_t(img).to(tdt), (29, 37)).float()
    tol = 1e-5 if dtype == jnp.float32 else 2 ** -7 * np.abs(img).max()
    np.testing.assert_allclose(got.numpy(), ref, atol=tol)


def test_posenc_matches_jax():
    x = np.random.RandomState(6).randn(4, 7, 3).astype(np.float32)
    ref = np.asarray(j_posenc(jnp.asarray(x), 6, 6.28))
    got = posenc(_t(x), 6, 6.28).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def _randomize_norms(variables, seed):
    """Non-trivial norm scale/bias and BatchNorm running stats, so the
    parity test exercises the mapping of every norm tensor."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "var":
                out[k] = jnp.asarray(rng.uniform(0.5, 2.0, v.shape), v.dtype)
            elif k in ("mean", "bias", "scale"):
                out[k] = jnp.asarray(rng.randn(*v.shape) * 0.2
                                     + (1.0 if k == "scale" else 0.0),
                                     v.dtype)
            else:
                out[k] = v
        return out

    return {name: walk(tree) for name, tree in variables.items()}


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_resnet34_trunk_matches_jax(norm):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 32, 40, 5).astype(np.float32)
    jm = JTrunk(backbone="resnet34", num_layers=4, norm=norm)
    variables = _randomize_norms(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 8)
    ref = jm.apply(variables, jnp.asarray(x))
    tm = ResNetTrunk(5, backbone="resnet34", num_layers=4, norm=norm).eval()
    tm.load_state_dict(from_jax(variables["params"],
                                variables.get("batch_stats")))
    with torch.no_grad():
        got = tm(_t(x).permute(0, 3, 1, 2))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(r), atol=1e-4, rtol=1e-4)


def test_spatial_encoder_matches_jax():
    """Edge padding, the border PE written only into the pad, and the
    pyramid upsample + concat, at the preset's padding_pe with a small
    image_padding."""
    rng = np.random.RandomState(9)
    x = rng.randn(2, 24, 28, 3).astype(np.float32)
    kw = dict(backbone="resnet34", num_layers=3, norm="group",
              image_padding=8, padding_pe=4)
    jm = JSpatialEncoder(**kw)
    variables = _randomize_norms(jm.init(jax.random.PRNGKey(1),
                                         jnp.asarray(x)), 10)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = SpatialEncoder(**kw).eval()
    tm.load_state_dict(from_jax(variables["params"]))
    with torch.no_grad():
        got = tm(_t(x)).numpy()
    assert got.shape == ref.shape == (2, 20, 22, 256)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_resnetfc_matches_jax():
    """Per-block latent injection and the view mean at combine_layer, with
    random nonzero weights everywhere (the init zeroes fc_1)."""
    rng = np.random.RandomState(11)
    d_latent, d_in = 16, 9
    zx = rng.randn(2, 3, 25, d_latent + d_in).astype(np.float32)
    kw = dict(d_in=d_in, d_out=4, n_blocks=4, d_latent=d_latent,
              d_hidden=32, combine_layer=2)
    jm = JResnetFC(**kw)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(zx), 1)["params"]
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.randn(*p.shape) * 0.2, p.dtype), params)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(zx), 1))
    tm = ResnetFC(**kw)
    tm.load_state_dict(from_jax(params))
    with torch.no_grad():
        got = tm(_t(zx), 1).numpy()
    assert got.shape == ref.shape == (2, 25, 4)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_diner_tpu():
    files = sorted((REPO / "diner_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    banned = ("jax", "jaxlib", "flax", "diner_tpu")
    bad = [(f.relative_to(REPO), m) for f in files for m in _imports(f)
           if m.split(".")[0] in banned]
    assert not bad, f"port files import JAX or diner_tpu: {bad}"
