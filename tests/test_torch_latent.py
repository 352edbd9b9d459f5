"""diner_tpu_torch's latent-fetch variants and lookups against diner_tpu on
the CPU.

The same numpy inputs go through the JAX function (eager, op by op) and the
port's:
- index_latent_anchored, index_latent_strided and index_latent_unique in
  float32 (within 1e-6), on a bf16 latent (within one bf16 rounding of the
  values, rtol and atol 2^-8) and, for the anchored and unique fetches, on
  an int8 quad latent with its scale (within 1e-6); a ragged case (NS not
  a multiple of A) and an overflowing run (more cells than K);
- the guard rails raise the same errors;
- PixelNeRF.field_gather dispatches as the JAX package's does, with and
  without the sampler's EpiAnchors;
- index_depth_std, index_normal, grid_sample's "exponential" padding and
  exponential_pad, inside and outside the frame.

The int8 strided fetch: the JAX package casts its in-cell weights and lerp
parameter to the rows' dtype, int8 there, which truncates them to 0 or 1.
The port blends in float32 instead; the last test shows both.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diner_tpu.core.types import SceneEncoding as JSceneEncoding
from diner_tpu.image_ops.grid_sample import exponential_pad as j_expo_pad
from diner_tpu.image_ops.grid_sample import grid_sample as j_grid_sample
from diner_tpu.image_ops.grid_sample import pack_quad as j_pack_quad
from diner_tpu.models import pixelnerf as jpn
from diner_tpu.sampler.depth_guided import EpiAnchors as JEpiAnchors
from diner_tpu_torch.core import SceneEncoding
from diner_tpu_torch.core.types import EpiAnchors
from diner_tpu_torch.image_ops import exponential_pad, grid_sample, pack_quad
from diner_tpu_torch.models import pixelnerf as tpn

SB, NV, H, W, C = 1, 2, 6, 8, 5
BF16_TOL = dict(rtol=2 ** -8, atol=2 ** -8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small ops: one intra-op thread runs them fastest under the
    Tier-1 command's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quantize(lat):
    scale = (np.abs(lat).reshape(-1, lat.shape[-1]).max(0) / 127.0
             ).astype(np.float32)
    return np.clip(np.round(lat / scale), -127, 127).astype(np.int8), scale


def _encs(kind="f32", seed=0):
    """The same encoding, with a quad latent, in both packages. kind: f32,
    bf16 or int8 (quantized with its per-channel scale)."""
    rng = np.random.RandomState(seed)
    lat = rng.randn(SB, NV, H, W, C).astype(np.float32)
    sb, nv, h, w = lat.shape[:4]
    scale = None
    if kind == "int8":
        lat, scale = _quantize(lat)
    depths = rng.uniform(1.0, 3.0, (sb, nv, h, w, 1)).astype(np.float32)
    stds = rng.uniform(0.01, 0.2, (sb, nv, h, w, 1)).astype(np.float32)
    normals = rng.randn(sb, nv, h, w, 3).astype(np.float32)
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (sb, nv, 4, 4))
    focal = np.full((sb, nv, 2), 6.0, np.float32)
    cxy = np.stack([np.full((sb, nv), w / 2), np.full((sb, nv), h / 2)],
                   -1).astype(np.float32)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}[kind]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16,
           "int8": torch.int8}[kind]
    jl = jnp.asarray(lat).astype(jdt)
    tl = torch.from_numpy(np.asarray(lat)).to(tdt)
    je = JSceneEncoding(
        latent=jl, depths=jnp.asarray(depths), depth_stds=jnp.asarray(stds),
        normals=jnp.asarray(normals), poses=jnp.asarray(poses),
        focal=jnp.asarray(focal), c=jnp.asarray(cxy),
        latent_quad=j_pack_quad(jl),
        latent_scale=None if scale is None else jnp.asarray(scale),
        feature_padding=0)
    te = SceneEncoding(
        latent=tl, depths=torch.from_numpy(depths),
        depth_stds=torch.from_numpy(stds), normals=torch.from_numpy(normals),
        poses=torch.from_numpy(poses.copy()), focal=torch.from_numpy(focal),
        c=torch.from_numpy(cxy), latent_quad=pack_quad(tl),
        latent_scale=None if scale is None else torch.from_numpy(scale),
        feature_padding=0)
    return je, te


def _uv(ix, iy, w=W, h=H):
    """Pixel coordinates (centres at 0..size-1) -> normalized uv."""
    return np.stack([(ix + 0.5) / w * 2.0 - 1.0,
                     (iy + 0.5) / h * 2.0 - 1.0], -1).astype(np.float32)


def _tracks(seed, NR, NS, reach_x=3.2, reach_y=1.7):
    """Chord-monotone sample tracks (SB, NV, NR * NS, 2) crossing several
    texel cells, and the EpiAnchors of their chords (slightly longer than
    the samples' span) in both packages."""
    rng = np.random.RandomState(seed)
    x0 = rng.uniform(0.3, 3.0, (SB, NV, NR, 1))
    y0 = rng.uniform(0.3, 3.0, (SB, NV, NR, 1))
    t = np.sort(rng.uniform(0.0, 1.0, (SB, NV, NR, NS)), -1)
    uv = _uv(x0 + t * reach_x, y0 + t * reach_y)          # (.., NR, NS, 2)
    uv0 = uv[..., 0, :] - 0.01
    duv = uv[..., -1, :] + 0.01 - uv0
    dd = (duv ** 2).sum(-1)
    depth = rng.uniform(1.0, 3.0, (SB, NV, NR, 7)).astype(np.float32)
    arrs = (uv0, duv, dd, depth)
    jaux = JEpiAnchors(*(jnp.asarray(a, jnp.float32) for a in arrs))
    taux = EpiAnchors(*(torch.from_numpy(a.astype(np.float32))
                        for a in arrs))
    return uv.reshape(SB, NV, NR * NS, 2), jaux, taux


def _fetch(name, je, te, uv, jaux, taux, NR, arg):
    ju, tu = jnp.asarray(uv), torch.from_numpy(uv)
    if name == "anchored":
        return (jpn.index_latent_anchored(je, ju, jaux, arg),
                tpn.index_latent_anchored(te, tu, taux, arg))
    if name == "strided":
        return (jpn.index_latent_strided(je, ju, NR, arg),
                tpn.index_latent_strided(te, tu, NR, arg))
    return (jpn.index_latent_unique(je, ju, NR, arg),
            tpn.index_latent_unique(te, tu, NR, arg))


# (fetch, its argument): anchors 5 over NS 12 samples (ragged: NS is not a
# multiple of A), stride 3, K 3 cells of tracks that cross up to 6 (the
# overflowing runs reuse run K-1's row)
FETCHES = [("anchored", 5), ("strided", 3), ("unique", 3)]
CASES = [(f, a, kind) for f, a in FETCHES for kind in ("f32", "bf16", "int8")
         if not (f == "strided" and kind == "int8")]


@pytest.mark.parametrize("fetch,arg,kind", CASES)
def test_fetch_variant_matches_jax(fetch, arg, kind):
    NR, NS = 4, 12
    je, te = _encs(kind)
    uv, jaux, taux = _tracks(1, NR, NS)
    ref, got = _fetch(fetch, je, te, uv, jaux, taux, NR, arg)
    # a bf16 latent's strided fetch stays bf16, as in JAX; the rest float32
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    assert got.shape == (SB, NV, NR * NS, C)
    ref = np.asarray(ref.astype(jnp.float32))
    if kind == "bf16":
        np.testing.assert_allclose(got.float().numpy(), ref, **BF16_TOL)
    else:
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)


def test_unique_overflow_and_exact_runs_match_jax():
    """K below and above the runs a ray's track crosses: both packages
    agree, and with K at least the runs both equal the exact fetch."""
    NR, NS = 4, 12
    je, te = _encs("f32", seed=4)
    uv, jaux, taux = _tracks(5, NR, NS, reach_x=4.5, reach_y=0.2)
    exact = tpn.index_latent(te, torch.from_numpy(uv)).numpy()
    for K in (1, 2, 8):
        ref, got = _fetch("unique", je, te, uv, jaux, taux, NR, K)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                                   rtol=0, err_msg=f"K={K}")
    np.testing.assert_allclose(got.numpy(), exact, atol=1e-6, rtol=0)
    assert np.abs(tpn.index_latent_unique(
        te, torch.from_numpy(uv), NR, 1).numpy() - exact).max() > 1e-3


def test_fetch_guard_rails_raise_as_jax():
    je, te = _encs("f32")
    uv, jaux, taux = _tracks(1, 4, 12)
    ju, tu = jnp.asarray(uv), torch.from_numpy(uv)
    jn = je.replace(latent_quad=None)
    tn = dataclasses.replace(te, latent_quad=None)
    cases = [
        (lambda: jpn.index_latent_anchored(je, ju, jaux, 1),
         lambda: tpn.index_latent_anchored(te, tu, taux, 1), "2 anchors"),
        (lambda: jpn.index_latent_strided(je, ju, 4, 5),
         lambda: tpn.index_latent_strided(te, tu, 4, 5), "divisible"),
        (lambda: jpn.index_latent_strided(jn, ju, 4, 2),
         lambda: tpn.index_latent_strided(tn, tu, 4, 2), "quad_latent"),
        (lambda: jpn.index_latent_unique(jn, ju, 4, 4),
         lambda: tpn.index_latent_unique(tn, tu, 4, 4), "quad_latent"),
    ]
    for j_call, t_call, match in cases:
        with pytest.raises(ValueError, match=match) as j_err:
            j_call()
        with pytest.raises(ValueError, match=match) as t_err:
            t_call()
        assert str(t_err.value) == str(j_err.value)


# settings of the three knobs -> the fetch JAX's field_gather picks
DISPATCH = [
    {},
    {"latent_anchors": 5},
    {"latent_unique_cells": 3},
    {"latent_sample_stride": 2},
    {"latent_sample_stride": 1},
    {"latent_anchors": 5, "latent_unique_cells": 3,
     "latent_sample_stride": 2},
    {"latent_unique_cells": 3, "latent_sample_stride": 2},
]


@pytest.mark.parametrize("with_aux", [False, True])
def test_field_gather_dispatches_as_jax(with_aux):
    """PixelNeRF.field_gather with each knob setting, on points whose
    projections are the tracks' (identity poses), with and without the
    EpiAnchors: latent and ref_depth within 1e-6 of JAX's."""
    NR, NS = 4, 12
    je, te = _encs("f32")   # the int8 strided fetch departs (last test)
    uv, jaux, taux = _tracks(2, NR, NS)
    # back-project uv at depth 2 through the cameras of _encs
    z = 2.0
    px = (uv[..., 0] + 1.0) * 0.5 * W
    py = (uv[..., 1] + 1.0) * 0.5 * H
    xyz = np.stack([(px - W / 2) / 6.0 * z, (py - H / 2) / 6.0 * z,
                    np.full_like(px, z)], -1)[:, 0].astype(np.float32)
    kw = dict(encoder_layers=2, n_blocks=1, d_hidden=8, combine_layer=1,
              quad_latent=True)
    seen = set()
    # without the anchors every setting is the exact fetch: none set and
    # all three set suffice
    for knobs in (DISPATCH if with_aux else [DISPATCH[0], DISPATCH[5]]):
        jm = jpn.PixelNeRF(**kw, **knobs)
        ref = jm.apply({}, je, jnp.asarray(xyz), jaux if with_aux else None,
                       method="field_gather")
        tm = tpn.PixelNeRF(**kw, **knobs)
        got = tm.field_gather(te, torch.from_numpy(xyz),
                              taux if with_aux else None)
        for key in ("latent", "ref_depth"):
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(ref[key]), atol=1e-6,
                                       rtol=0, err_msg=f"{knobs} {key}")
        seen.add(got["latent"].numpy().tobytes())
    # with the anchors the knobs pick four distinct fetches, without them
    # every setting is the exact one
    assert len(seen) == (4 if with_aux else 1)


def test_lookups_match_jax_inside_and_outside_the_frame():
    """index_depth_std (exponential padding: x2 every 12 px, 0 beyond 100
    px), index_normal (nearest, zeros outside) and grid_sample's
    exponential mode at its defaults, uv inside, within 3 and within 60
    image half-widths of the centre (past the padding's reach): within 1e-6
    relative; exponential_pad materialized."""
    je, te = _encs("f32", seed=3)
    rng = np.random.RandomState(6)
    uv = rng.uniform(-3.0, 3.0, (SB, NV, 300, 2)).astype(np.float32)
    uv[..., :50, :] = rng.uniform(-1.0, 1.0, (SB, NV, 50, 2))
    uv[..., 200:, :] = rng.uniform(-60.0, 60.0, (SB, NV, 100, 2))
    ju, tu = jnp.asarray(uv), torch.from_numpy(uv)
    pairs = [(jpn.index_depth_std(je, ju), tpn.index_depth_std(te, tu)),
             (jpn.index_normal(je, ju), tpn.index_normal(te, tu)),
             (j_grid_sample(je.depths, ju, "nearest", "exponential"),
              grid_sample(te.depths, tu, "nearest", "exponential"))]
    for ref, got in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
        assert (ref == 0).any() and (ref != 0).any()
    std = pairs[0][1].numpy()
    assert std.max() > te.depth_stds.max().item()   # grown outside
    img = np.asarray(je.depth_stds[0])
    np.testing.assert_allclose(
        exponential_pad(torch.from_numpy(img), 5, 3.0).numpy(),
        np.asarray(j_expo_pad(jnp.asarray(img), 5, 3.0)), rtol=1e-6)
    with pytest.raises(ValueError, match="nearest"):
        grid_sample(te.depths, tu, "bilinear", "exponential")


def test_int8_strided_matches_exact_where_jax_departs():
    """The cell-shared inputs of tests/test_latent_strided.py:48 (every
    sample of a (ray, view) in one texel cell; 12 samples here, 8 there)
    on an int8 quad latent: the port's
    strided fetch equals the exact fetch of both packages within 1e-6;
    the JAX package's strided fetch, whose int8 weights truncate to 0 or
    1, departs from it by more than 1 (2.02 when written)."""
    NR, NS = 4, 12
    je, te = _encs("int8")
    rng = np.random.RandomState(1)
    x0 = rng.randint(0, W - 1, (1, 2, NR, 1))
    y0 = rng.randint(0, H - 1, (1, 2, NR, 1))
    frac = np.linspace(0.0, 0.4, NS)[None, None, None]
    uv = _uv(x0 + 0.3 + frac, y0 + 0.3 + frac * 0.5).reshape(1, 2, NR * NS,
                                                              2)
    ju, tu = jnp.asarray(uv), torch.from_numpy(uv)
    exact_j = np.asarray(jpn.index_latent(je, ju))
    exact_t = tpn.index_latent(te, tu).numpy()
    got = tpn.index_latent_strided(te, tu, NR, 2).numpy()
    np.testing.assert_allclose(exact_t, exact_j, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, exact_t, atol=1e-6, rtol=0)
    jax_strided = np.asarray(jpn.index_latent_strided(je, ju, NR, 2))
    assert np.abs(jax_strided - exact_j).max() > 1.0
