"""diner_tpu_torch.fusion, the dmb and gipuma codecs and `cli/mvs fuse`
against diner_tpu on the CPU.

The geometry is tests/test_fusion.py's: cameras on short x-baselines
looking at the plane z = 2, here with a tilt, noise of 0.4% and a few holes
in the depths, and random confidences, so that every threshold keeps some
pixels and drops others. Tolerances (float32): masks and point counts
equal; depths and points within 1e-5 abs; colours equal; the files of the
codecs and PLY writers byte for byte.
"""

import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diner_tpu.cli import mvs as j_mvs_cli
from diner_tpu.data import codecs as j_codecs
from diner_tpu.fusion import consensus as j_consensus
from diner_tpu.fusion import consistency as j_consistency
from diner_tpu.fusion import ply as j_ply
from diner_tpu_torch.cli import mvs as mvs_cli
from diner_tpu_torch.data import codecs
from diner_tpu_torch.fusion import consensus
from diner_tpu_torch.fusion import (check_geometric_consistency,
                                    consensus_fusion, depths_to_world_points,
                                    filter_depths, filter_depths_dynamic,
                                    read_ply, read_ply_mesh,
                                    reproject_with_depth, write_ply)

sys.path.insert(0, str(Path(__file__).parent))
from test_mvs_cli import _cams  # noqa: E402

H = W = 16


def _views(V=4, seed=0):
    """V cameras on x-baselines over a tilted, noisy plane near z = 2, with
    holes; confidences uniform in [0, 1]; colours in [0, 1]."""
    rng = np.random.RandomState(seed)
    K = np.array([[16.0, 0, W / 2], [0, 16.0, H / 2], [0, 0, 1]], np.float32)
    exts = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    exts[:, 0, 3] = np.array([0.0, 0.05, -0.05, 0.1, -0.1, 0.08])[:V]
    exts[:, 1, 3] = np.array([0.0, 0.02, 0.0, -0.03, 0.01, 0.0])[:V]
    yy = np.arange(H, dtype=np.float32)[:, None]
    depths = (2.0 + 0.01 * yy + np.zeros((V, H, W), np.float32)
              ) * (1 + 0.004 * rng.randn(V, H, W))
    depths[rng.rand(V, H, W) < 0.05] = 0.0
    conf = rng.rand(V, H, W)
    colors = rng.rand(V, H, W, 3)
    normals = rng.randn(V, H, W, 3)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    f32 = np.float32
    return (depths.astype(f32), np.stack([K] * V), exts, conf.astype(f32),
            colors.astype(f32), normals.astype(f32))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_reprojection_and_consistency_match_jax():
    depths, Ks, exts, *_ = _views(2)
    args = (depths[0], Ks[0], exts[0], depths[1], Ks[1], exts[1])
    want = [np.asarray(a) for a in j_consistency.reproject_with_depth(
        *map(jnp.asarray, args))]
    got = reproject_with_depth(*map(_t, args))
    for name, g, w in zip(("depth", "x", "y", "x_src", "y_src"), got, want):
        finite = np.isfinite(w)
        np.testing.assert_allclose(g.numpy()[finite], w[finite], atol=1e-5,
                                   err_msg=name)
    wm, wd = j_consistency.check_geometric_consistency(
        *map(jnp.asarray, args))
    gm, gd = check_geometric_consistency(*map(_t, args))
    assert 0 < np.asarray(wm).sum() < wm.size
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=1e-5)


@pytest.mark.parametrize("dynamic", [False, True])
def test_filter_depths_match_jax(dynamic):
    depths, Ks, exts, conf, _, _ = _views(4)
    if dynamic:
        want = j_consistency.filter_depths_dynamic(
            jnp.asarray(depths), jnp.asarray(Ks), jnp.asarray(exts),
            jnp.asarray(conf), conf_thresh=0.3)
        got = filter_depths_dynamic(_t(depths), _t(Ks), _t(exts), _t(conf),
                                    conf_thresh=0.3)
    else:
        want = j_consistency.filter_depths(
            jnp.asarray(depths), jnp.asarray(Ks), jnp.asarray(exts),
            jnp.asarray(conf), conf_thresh=0.3, thres_view=2)
        got = filter_depths(_t(depths), _t(Ks), _t(exts), _t(conf),
                            conf_thresh=0.3, thres_view=2)
    wa, wf = (np.asarray(a) for a in want)
    assert 0 < wf.sum() < wf.size
    np.testing.assert_array_equal(got[1].numpy(), wf)
    np.testing.assert_allclose(got[0].numpy(), wa, atol=1e-5)


def test_depths_to_world_points_match_jax():
    depths, Ks, exts, conf, colors, _ = _views(3)
    mask = conf > 0.5
    want = j_consistency.depths_to_world_points(depths, Ks, exts, colors,
                                                mask)
    got = depths_to_world_points(_t(depths), _t(Ks), _t(exts), _t(colors),
                                 torch.from_numpy(mask))
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("mode,with_normals",
                         [("relative", False), ("relative", True),
                          ("disparity", False)])
def test_consensus_fusion_matches_jax(mode, with_normals, monkeypatch):
    """Relative and disparity agreement, fake normals and given ones; the
    port with its sources in chunks of 2 (JAX: all at once)."""
    monkeypatch.setattr(consensus, "SRC_CHUNK", 2)
    depths, Ks, exts, _, colors, normals = _views(5)
    thresh = 0.01 if mode == "relative" else 0.5
    kw = dict(colors=colors, depth_thresh=thresh, num_consistent=2,
              depth_mode=mode,
              normals=normals if with_normals else None,
              normal_thresh=1.2)
    want = {k: np.asarray(v) for k, v in j_consensus.consensus_fusion(
        depths, Ks, exts, **kw).items()}
    got = consensus_fusion(depths, Ks, exts, **kw)
    keep = want["keep"]
    assert 0 < keep.sum() < keep.size
    np.testing.assert_array_equal(got["keep"].numpy(), keep)
    for k in ("points", "normals", "colors"):
        np.testing.assert_allclose(got[k].numpy()[keep], want[k][keep],
                                   atol=1e-5, err_msg=k)


def test_dmb_and_gipuma_files_match_jax_byte_for_byte(tmp_path):
    depths, Ks, exts, *_ = _views(1)
    img = np.random.RandomState(1).rand(5, 7, 3).astype(np.float32)
    for tag, arr in (("depth", depths[0]), ("rgb", img)):
        j_codecs.write_dmb(tmp_path / f"j_{tag}.dmb", arr)
        codecs.write_dmb(tmp_path / f"t_{tag}.dmb", arr)
        want = (tmp_path / f"j_{tag}.dmb").read_bytes()
        assert (tmp_path / f"t_{tag}.dmb").read_bytes() == want
        np.testing.assert_array_equal(codecs.read_dmb(tmp_path /
                                                      f"j_{tag}.dmb"),
                                      j_codecs.read_dmb(tmp_path /
                                                        f"j_{tag}.dmb"))
    np.testing.assert_array_equal(codecs.fake_gipuma_normals(depths[0]),
                                  j_codecs.fake_gipuma_normals(depths[0]))
    j_codecs.write_gipuma_cam(tmp_path / "j.P", exts[0], Ks[0])
    codecs.write_gipuma_cam(tmp_path / "t.P", exts[0], Ks[0])
    assert (tmp_path / "t.P").read_bytes() == (tmp_path / "j.P").read_bytes()


@pytest.mark.parametrize("fields", [(), ("colors",), ("normals",),
                                    ("colors", "normals")])
def test_ply_writers_byte_identical_with_both_readers(tmp_path, fields):
    rng = np.random.RandomState(2)
    pts = rng.randn(70000, 3).astype(np.float32)      # over one 65536 chunk
    kw = {}
    if "colors" in fields:
        kw["colors"] = rng.rand(len(pts), 3)           # floats -> uint8
    if "normals" in fields:
        kw["normals"] = rng.randn(len(pts), 3).astype(np.float32)
    write_ply(tmp_path / "native.ply", pts, **kw)
    write_ply(tmp_path / "python.ply", pts, use_native=False, **kw)
    j_ply.write_ply(tmp_path / "jax.ply", pts, use_native=False, **kw)
    want = (tmp_path / "jax.ply").read_bytes()
    assert (tmp_path / "native.ply").read_bytes() == want
    assert (tmp_path / "python.ply").read_bytes() == want
    got, ref = read_ply(tmp_path / "native.ply"), j_ply.read_ply(
        tmp_path / "jax.ply")
    assert got.keys() == ref.keys() == {"points", *fields}
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian"])
def test_read_ply_mesh_matches_jax(tmp_path, fmt):
    verts = np.random.RandomState(3).rand(6, 3).astype(np.float32)
    faces = [[0, 1, 2], [2, 3, 4, 5]]             # a quad: fan-triangulated
    path = tmp_path / "mesh.ply"
    head = (f"ply\nformat {fmt} 1.0\nelement vertex 6\nproperty float x\n"
            "property float y\nproperty float z\nproperty uchar red\n"
            "element face 2\nproperty list uchar int vertex_indices\n"
            "end_header\n").encode()
    if fmt == "ascii":
        body = "".join(f"{x} {y} {z} 7\n" for x, y, z in verts)
        body += "".join(f"{len(f)} " + " ".join(map(str, f)) + "\n"
                        for f in faces)
        path.write_bytes(head + body.encode())
    else:
        rec = np.empty(6, [("xyz", "<f4", 3), ("r", "u1")])
        rec["xyz"], rec["r"] = verts, 7
        body = rec.tobytes() + b"".join(
            np.uint8(len(f)).tobytes() + np.asarray(f, "<i4").tobytes()
            for f in faces)
        path.write_bytes(head + body)
    gv, gf = read_ply_mesh(path)
    wv, wf = j_ply.read_ply_mesh(path)
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gf, wf)
    assert gf.shape == (3, 3)


@pytest.fixture(scope="module")
def eval_tree(tmp_path_factory):
    """One tiny `mvs eval` output tree (test_mvs_cli's 4 cams at 32x32 over
    the plane z = 2) with noisy depths, holes and random confidences, and
    its pair list."""
    from PIL import Image

    root = tmp_path_factory.mktemp("fuse")
    exts, K = _cams()
    V = len(exts)
    rng = np.random.RandomState(4)
    scan = root / "out" / "scan9"
    for sub in ("depth_est", "confidence", "cams", "images"):
        (scan / sub).mkdir(parents=True)
    for v in range(V):
        d = (2.0 * (1 + 0.003 * rng.randn(32, 32))).astype(np.float32)
        d[rng.rand(32, 32) < 0.05] = 0.0
        codecs.write_pfm(scan / "depth_est" / f"{v:08d}.pfm", d)
        codecs.write_pfm(scan / "confidence" / f"{v:08d}.pfm",
                         rng.rand(32, 32).astype(np.float32))
        codecs.write_mvsnet_cam(scan / "cams" / f"{v:08d}_cam.txt", exts[v],
                                K[v], 1.0, 2.0 / 32)
        Image.fromarray((rng.rand(32, 32, 3) * 255).astype(np.uint8)).save(
            scan / "images" / f"{v:08d}.png")
    (root / "data" / "scan9").mkdir(parents=True)
    lines = [str(V)]
    for v in range(V):
        srcs = [s for s in range(V) if s != v]
        lines += [str(v), f"{len(srcs)} " + " ".join(f"{s} 100.0"
                                                     for s in srcs)]
    (root / "data" / "scan9" / "pair.txt").write_text("\n".join(lines) + "\n")
    return root


@pytest.mark.parametrize("method", ["normal", "dynamic", "consensus"])
def test_cli_fuse_matches_jax(eval_tree, tmp_path, method):
    """`mvs fuse` against JAX's on the same eval outputs: the same PLY name,
    point count and colours, points within 1e-5."""
    argv = {}
    for tag in ("jax", "port"):
        shutil.copytree(eval_tree / "out", tmp_path / tag)
        argv[tag] = ["fuse", "--datapath", str(eval_tree / "data"),
                     "--testlist", "scan9", "--outdir", str(tmp_path / tag),
                     "--method", method, "--conf", "0.3", "--thres_view",
                     "2", "--num_consistent", "2"]
    j_mvs_cli.main(argv["jax"])
    res = mvs_cli.main(argv["port"] + ["--device", "cpu"])
    want = read_ply(tmp_path / "jax" / "mvsnet009_l3.ply")
    got = read_ply(tmp_path / "port" / "mvsnet009_l3.ply")
    assert res["scan9"]["points"] == len(got["points"])
    assert 100 < len(want["points"]) < 4 * 32 * 32
    assert len(got["points"]) == len(want["points"])
    np.testing.assert_allclose(got["points"], want["points"], atol=1e-5)
    np.testing.assert_array_equal(got["colors"], want["colors"])
