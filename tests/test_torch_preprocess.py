"""diner_tpu_torch.preprocess (the batched z-buffer, FaceScape and MultiFace
preprocessing, colour calibration, the MultiFace download) against
diner_tpu.preprocess on the CPU.

The JAX package's preprocessing is numpy (its rasterizer loops over
triangles in Python); the port renders with batched torch ops in float64
on the device it is given ("cpu" here). Tolerances:
- render_depth: depth and mask equal, bit for bit. The projection's
  float64 matmul rounds as numpy's does on the CPU, and every later op is
  one IEEE operation in the JAX function's operand order;
- vertex_visibility: the visible set equal, uv within 1e-6 relative (its
  projection runs in the inputs' float32, where another matmul order could
  move the last bit);
- calibrate_cameras, calibrate_pose_dir's transforms: within 1e-6 (the
  same float64 numpy code on the same colours);
- the written PNGs decoded equal, cameras.json equal.
No test reaches the network: the download runs over file:// and an
injected fetch.
"""

import hashlib
import io
import json
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from diner_tpu.preprocess import color_calib as j_calib
from diner_tpu.preprocess import facescape_pipeline as j_pipe
from diner_tpu.fusion.ply import read_ply_mesh as j_read_ply_mesh
from diner_tpu.preprocess import multiface as j_mf
from diner_tpu.preprocess.rasterizer import render_depth as j_render_depth
from diner_tpu_torch.data.codecs import read_depth_png
from diner_tpu_torch.data.synthetic import _lookat
from diner_tpu_torch.image_ops.png import read_png, write_png
from diner_tpu_torch.preprocess import color_calib, facescape_pipeline
from diner_tpu_torch.fusion.ply import read_ply_mesh
from diner_tpu_torch.preprocess import multiface as mf
from diner_tpu_torch.preprocess import rasterizer
from diner_tpu_torch.preprocess.rasterizer import render_depth

QUAD_K = np.array([[8.0, 0, 16], [0, 8.0, 16], [0, 0, 1]])


def _sphere(n_lat, n_lon, radius, center=(0.0, 0.0, 0.0), seed=0):
    """A closed UV sphere with its radius displaced by a seeded ripple:
    (vertices (V, 3) float64, faces (F, 3) int64)."""
    rng = np.random.RandomState(seed)
    th = np.linspace(0, np.pi, n_lat + 1)[1:-1]
    ph = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    a = rng.uniform(0.02, 0.06, 3)
    r = radius * (1 + a[0] * np.sin(3 * T) * np.cos(2 * P)
                  + a[1] * np.cos(5 * P) + a[2] * np.sin(4 * T + P))
    ring = np.stack([r * np.sin(T) * np.cos(P), r * np.sin(T) * np.sin(P),
                     r * np.cos(T)], -1).reshape(-1, 3)
    verts = np.concatenate([[[0, 0, radius]], ring, [[0, 0, -radius]]])
    verts = verts + np.asarray(center)
    idx = 1 + np.arange((n_lat - 1) * n_lon).reshape(n_lat - 1, n_lon)
    nxt = np.roll(idx, -1, axis=1)
    faces = [np.stack([np.zeros(n_lon, int), nxt[0], idx[0]], -1)]
    faces.append(np.stack([idx[:-1], nxt[:-1], nxt[1:]], -1).reshape(-1, 3))
    faces.append(np.stack([idx[:-1], nxt[1:], idx[1:]], -1).reshape(-1, 3))
    last = len(verts) - 1
    faces.append(np.stack([np.full(n_lon, last), idx[-1], nxt[-1]], -1))
    return verts, np.concatenate(faces).astype(np.int64)


def _random_mesh():
    """About 300 random triangles in front of the camera, plus one across
    the near plane, one degenerate (a line) and one off the frame."""
    rng = np.random.RandomState(3)
    verts = rng.randn(160, 3) * [0.6, 0.5, 0.3] + [0, 0, 2.0]
    faces = rng.randint(0, 160, (297, 3))
    extra = np.array([[0.0, 0.0, -0.5], [0.2, 0.1, 1.0], [-0.2, 0.1, 1.5],
                      [0.0, 0.0, 1.2], [0.1, 0.1, 1.2], [0.2, 0.2, 1.2],
                      [30.0, 30.0, 2.0], [31.0, 30.0, 2.0], [30.0, 31.0, 2.0]])
    faces = np.concatenate([faces, 160 + np.arange(9).reshape(3, 3)])
    return np.concatenate([verts, extra]), faces


def _rotated_ext():
    e = _lookat(np.array([0.6, -0.4, -1.5]), target=(0.0, 0.0, 2.0))
    return e.astype(np.float64)


def _case(name):
    quad = (np.array([[-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]],
                     float), np.array([[0, 1, 2], [0, 2, 3]]))
    if name == "quad":
        return (*quad, QUAD_K, np.eye(4), 32, 32)
    if name == "occluder":
        verts = np.array([[-1, -1, 2], [1, -1, 2], [0, 1, 2],
                          [-1, -1, 1.5], [1, -1, 1.5], [0, 1, 1.5]], float)
        return verts, np.array([[0, 1, 2], [3, 4, 5]]), QUAD_K, np.eye(4), \
            32, 32
    if name == "rotated":
        return (*quad, QUAD_K, _rotated_ext(), 32, 40)
    verts, faces = _random_mesh()
    K = np.array([[30.0, 0, 20.5], [0, 31.0, 15.0], [0, 0, 1]])
    return verts, faces, K, np.eye(4), 30, 41


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The renders here are many small ops: one intra-op thread runs them
    fastest beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["quad", "occluder", "rotated", "random"])
def test_render_depth_matches_jax(name, monkeypatch):
    """Depth and mask bit for bit, at the default pair budget and at one
    that forces many chunks and splits the quads' triangles into bands."""
    verts, faces, K, ext, H, W = _case(name)
    want_d, want_m = j_render_depth(verts, faces, K, ext, H, W)
    assert want_m.any() and not want_m.all()
    for budget in (rasterizer.PAIR_BUDGET, 512):
        monkeypatch.setattr(rasterizer, "PAIR_BUDGET", budget)
        d, m = render_depth(verts, faces, K, ext, H, W, device="cpu")
        assert d.dtype == torch.float32 and m.dtype == torch.bool
        np.testing.assert_array_equal(d.numpy(), want_d)
        np.testing.assert_array_equal(m.numpy(), want_m)


def test_render_depth_splits_a_large_triangle_into_bands(monkeypatch):
    """A triangle over the whole frame with a pair budget of 2 W is
    enumerated in bands of one row; the result is still JAX's."""
    verts = np.array([[-5, -5, 2.0], [5, -5, 3.0], [0, 5, 2.5],
                      [-0.2, -0.2, 1.0], [0.2, -0.2, 1.0], [0, 0.3, 1.0]])
    faces = np.array([[0, 1, 2], [3, 4, 5]])
    want_d, want_m = j_render_depth(verts, faces, QUAD_K, np.eye(4), 24, 32)
    monkeypatch.setattr(rasterizer, "PAIR_BUDGET", 64)
    d, m = render_depth(verts, faces, QUAD_K, np.eye(4), 24, 32,
                        device="cpu")
    np.testing.assert_array_equal(d.numpy(), want_d)
    np.testing.assert_array_equal(m.numpy(), want_m)
    monkeypatch.setattr(rasterizer, "PAIR_BUDGET", 63)
    with pytest.raises(ValueError, match="PAIR_BUDGET"):
        render_depth(verts, faces, QUAD_K, np.eye(4), 24, 32, device="cpu")


def test_render_depth_of_a_closed_mesh_matches_jax():
    """A closed, displaced sphere from an oblique camera (every triangle
    rendered whatever its winding; the far side hidden)."""
    verts, faces = _sphere(12, 24, 0.3, center=(0.05, -0.02, 2.0))
    K = np.array([[50.0, 0, 24.0], [0, 50.0, 20.0], [0, 0, 1]])
    ext = _rotated_ext()
    want_d, want_m = j_render_depth(verts, faces, K, ext, 40, 48)
    d, m = render_depth(verts, faces, K, ext, 40, 48, device="cpu")
    np.testing.assert_array_equal(d.numpy(), want_d)
    np.testing.assert_array_equal(m.numpy(), want_m)


def test_read_ply_mesh_of_binary_triangles_matches_jax(tmp_path):
    """A binary scan of triangles alone reads as one record array (a quad
    among them takes the per-face loop: tests/test_torch_fusion.py); the
    vertices and faces are JAX's."""
    verts, faces = _sphere(6, 8, 0.1)
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\nproperty float x\n"
            "property float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n").encode()
    rec = np.empty(len(faces), [("n", "u1"), ("i", "<i4", 3)])
    rec["n"], rec["i"] = 3, faces
    path = tmp_path / "scan.ply"
    path.write_bytes(head + verts.astype("<f4").tobytes() + rec.tobytes())
    got, want = read_ply_mesh(path), j_read_ply_mesh(path)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], faces)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_vertex_visibility_matches_jax(dtype):
    verts, faces = _sphere(10, 20, 0.3, center=(0.0, 0.0, 2.0))
    verts = np.concatenate([verts, [[0.0, 0.0, 1.0], [5.0, 0.0, 2.0]]])
    verts = verts.astype(dtype)
    K = np.array([[60.0, 0, 24.0], [0, 60.0, 20.0], [0, 0, 1]], dtype)
    ext = np.eye(4, dtype=dtype)
    want_v, want_uv = j_calib.vertex_visibility(verts, faces, K, ext, 40, 48)
    vis, uv = color_calib.vertex_visibility(verts, faces, K, ext, 40, 48,
                                            device="cpu")
    assert 0 < want_v.sum() < len(verts)
    np.testing.assert_array_equal(vis, want_v)
    assert uv.dtype == want_uv.dtype
    np.testing.assert_allclose(uv, want_uv, rtol=1e-6)


def test_calibrate_cameras_matches_jax():
    rng = np.random.RandomState(5)
    cols = rng.rand(3, 200, 3).astype(np.float32)
    cols[0] = cols[0] * 0.8 + 0.05
    cols[rng.rand(3, 200) < 0.3] = np.nan
    cols[2, 10:] = np.nan             # under 16 vertices: the identity
    want = j_calib.calibrate_cameras(cols)
    got = color_calib.calibrate_cameras(cols)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6)
    np.testing.assert_array_equal(got[2], np.eye(3, 4, dtype=np.float32))


def _calib_pose(tmp_path):
    """Two views of a textured grid at z = 1, one with a colour cast (the
    JAX test's scene), written by the port's PNG writer."""
    H = W = 48
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    n = 9
    gy, gx = np.mgrid[0:n, 0:n].astype(np.float32) / (n - 1)
    verts = np.stack([gx * 0.8 - 0.4, gy * 0.8 - 0.4, np.ones_like(gx)],
                     -1).reshape(-1, 3)
    faces = np.asarray([f for r in range(n - 1) for c in range(n - 1)
                        for f in ([r * n + c, r * n + c + 1, r * n + c + n + 1],
                                  [r * n + c, r * n + c + n + 1,
                                   r * n + c + n])], np.int32)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32) + 0.5
    pose = tmp_path / "pose"
    cams = {}
    for i, (scale, offset) in enumerate([(1.0, 0.0), (0.7, 0.1)]):
        ext = np.eye(4, dtype=np.float32)
        ext[0, 3] = 0.02 * i
        depth, mask = j_render_depth(verts, faces, K, ext[:3], H, W)
        wx = (xs - K[0, 2]) / K[0, 0] * depth - ext[0, 3]
        wy = (ys - K[1, 2]) / K[1, 1] * depth
        tex = np.stack([0.2 + 0.6 * (wx + 0.4) / 0.8,
                        np.full_like(wx, 0.5), 0.2 + 0.6 * (wy + 0.4) / 0.8],
                       -1)
        rgb = np.ones((H, W, 3), np.float32)
        rgb[mask] = np.clip(tex[mask] * scale + offset, 0, 1)
        rgba = np.concatenate([rgb, mask[..., None].astype(np.float32)], -1)
        (pose / f"view_{i:05d}").mkdir(parents=True)
        write_png(pose / f"view_{i:05d}" / "rgba.png",
                  (rgba * 255).astype(np.uint8))
        cams[str(i)] = {"extrinsics": ext[:3].tolist(),
                        "intrinsics": K.tolist()}
    (pose / "cameras.json").write_text(json.dumps(cams))
    return pose, verts, faces


def test_calibrate_pose_dir_matches_jax(tmp_path):
    pose, verts, faces = _calib_pose(tmp_path)
    want = j_calib.calibrate_pose_dir(pose, verts, faces, out_name="jax.png")
    got = color_calib.calibrate_pose_dir(pose, verts, faces, device="cpu")
    assert set(got) == set(want) == {"0", "1"}
    for i in want:
        np.testing.assert_allclose(got[i], want[i], atol=1e-6)
        view = pose / f"view_{int(i):05d}"
        np.testing.assert_array_equal(read_png(view / "rgba_colorcalib.png"),
                                      read_png(view / "jax.png"))
    assert not np.allclose(want["1"], np.eye(3, 4), atol=1e-2)


def test_process_view_matches_jax():
    rng = np.random.RandomState(0)
    H, W = 60, 72
    img = rng.randint(0, 255, (H, W, 3), dtype=np.uint8)
    K = np.array([[70.0, 0, W / 2], [0, 70.0, H / 2], [0, 0, 1]], np.float32)
    dist = np.array([0.05, -0.02, 0.001, 0.0, 0.0], np.float32)
    verts, faces = _sphere(10, 20, 0.2, center=(0.03, 0.0, 1.2))
    ext = np.eye(4, dtype=np.float32)[:3]
    want = j_pipe.process_view(img, K, dist, ext, verts, faces, crop_out=32)
    got = facescape_pipeline.process_view(img, K, dist, ext, verts, faces,
                                          crop_out=32, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (want[1] > 0).any()


def _raw_subject(root):
    """A raw FaceScape subject (pose 1): a displaced-sphere scan in mm in
    the raw frame, 3 cams (one invalid, one JPEG) and the similarity that
    aligns the scan to a metric head frame (a rotation, scale 1e-3 and a
    translation). Returns the alignment dict."""
    from scipy.spatial.transform import Rotation

    R_a = Rotation.from_euler("xyz", [0.3, -0.2, 0.5]).as_matrix()
    t_a = np.array([0.01, -0.02, 0.03])
    s = 1e-3
    verts_m, faces = _sphere(10, 20, 0.1)
    verts_raw = (verts_m - t_a) @ R_a / s         # R_a^T (y - t) / s
    raw = root / "1_neutral"
    raw.mkdir(parents=True)
    head = ("ply\nformat ascii 1.0\n"
            f"element vertex {len(verts_raw)}\nproperty float x\n"
            "property float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n")
    body = "".join(f"{x:.4f} {y:.4f} {z:.4f}\n" for x, y, z in verts_raw)
    body += "".join(f"3 {a} {b} {c}\n" for a, b, c in faces)
    (root / "1_neutral.ply").write_text(head + body)
    H = W = 64
    K = [[70.0, 0, W / 2], [0, 70.0, H / 2], [0, 0, 1]]
    rng = np.random.RandomState(1)
    params = {}
    for i, eye in enumerate([(0.0, -0.1, -0.6), (0.3, 0.0, -0.5),
                             (-0.3, 0.1, -0.5)]):
        e = _lookat(np.array(eye))
        R_e = e[:3, :3] @ R_a                     # cams in the raw frame
        t_e = (e[:3, 3] + e[:3, :3] @ t_a) / s
        params[f"{i}_K"] = K
        params[f"{i}_Rt"] = np.concatenate([R_e, t_e[:, None]], 1).tolist()
        params[f"{i}_distortion"] = [0.02, -0.01, 0, 0, 0]
        params[f"{i}_valid"] = i != 2
        img = rng.randint(0, 255, (H, W, 3), dtype=np.uint8)
        if i == 1:
            Image.fromarray(img).save(raw / f"{i}.jpg", quality=90)
        else:
            write_png(raw / f"{i}.png", img)
    (raw / "params.json").write_text(json.dumps(params))
    Rt = np.eye(4)
    Rt[:3, :3], Rt[:3, 3] = R_a, t_a
    return {"1": {"scale": s, "Rt": Rt.tolist()}}


def test_process_subject_matches_jax(tmp_path):
    """A raw subject with an alignment: the same views, decoded PNGs and
    cameras.json as JAX's; the cameras stay rigid and the depths metric."""
    align = _raw_subject(tmp_path / "raw")
    want = j_pipe.process_subject(tmp_path / "raw", tmp_path / "jax", align,
                                  crop_out=32)
    got = facescape_pipeline.process_subject(tmp_path / "raw",
                                             tmp_path / "port", align,
                                             crop_out=32, device="cpu")
    assert [p.name for p in got] == [p.name for p in want] == ["1"]
    files = sorted(p.relative_to(want[0])
                   for p in want[0].rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(got[0])
                           for p in got[0].rglob("*") if p.is_file())
    assert len(files) == 5            # 2 valid views x 2 PNGs, cameras.json
    for rel in files:
        if rel.suffix == ".png":
            np.testing.assert_array_equal(read_png(got[0] / rel),
                                          read_png(want[0] / rel), str(rel))
    cams = json.loads((got[0] / "cameras.json").read_text())
    assert cams == json.loads((want[0] / "cameras.json").read_text())
    R = np.asarray(cams["0"]["extrinsics"])[:, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    d = read_depth_png(got[0] / "view_00000" / "depth.png")
    assert 0.45 < d[d > 0].min() and d.max() < 0.75


def test_render_frame_and_outputs_match_jax(tmp_path):
    verts, faces = _sphere(10, 20, 100.0, center=(0.0, 0.0, 1000.0))
    e = _lookat(np.array([0.1, 0.0, -0.1]), target=(0.0, 0.0, 1.0))
    e[:3, 3] *= 1000.0                                    # mm
    krt = {"intrin": np.array([[40.0, 0, 16], [0, 40.0, 20], [0, 0, 1]]),
           "extrin": e[:3]}
    want_d, want_m = j_mf.render_frame(verts, faces, krt, 40, 32)
    d, m = mf.render_frame(verts, faces, krt, 40, 32, device="cpu")
    np.testing.assert_array_equal(d.numpy(), want_d)
    np.testing.assert_array_equal(m.numpy(), want_m)
    assert 0.8 < want_d[want_m].min() and want_d.max() < 1.2
    j_mf.write_frame_outputs(want_d, want_m, tmp_path / "j" / "d.png",
                             tmp_path / "j" / "m.png")
    mf.write_frame_outputs(d, m, tmp_path / "t" / "d.png",
                           tmp_path / "t" / "m.png")
    for name in ("d.png", "m.png"):
        np.testing.assert_array_equal(read_png(tmp_path / "t" / name),
                                      read_png(tmp_path / "j" / name))


def _mirror(tmp_path, entity, exp):
    """A file:// mirror of one entity: three image tars (one of another
    expression, one of an excluded category), a metadata tar, CHECKSUM and
    index.html."""
    mirror = tmp_path / "mirror" / entity
    mirror.mkdir(parents=True)
    names = [f"--images--{exp}--cam1.tar", "--images--SEN_other--cam1.tar",
             f"--unwrapped_uv--{exp}--cam1.tar"]
    for t in names:
        with tarfile.open(mirror / t, "w") as tf:
            info = tarfile.TarInfo(f"{entity}{t[:-4]}/img.bin")
            info.size = 11
            tf.addfile(info, io.BytesIO(b"image-bytes"))
    with tarfile.open(mirror / "metadata.tar", "w") as tf:
        info = tarfile.TarInfo("metadata/meta.bin")
        info.size = 4
        tf.addfile(info, io.BytesIO(b"meta"))
    (mirror / "CHECKSUM").write_text("\n".join(
        f"{mf.md5sum(mirror / t)}  {t}" for t in names + ["metadata.tar"]))
    names += ["metadata.tar", "CHECKSUM", "index.html"]
    (mirror / "index.html").write_text("<html>" + "".join(
        f'<a href="{n}">{n}</a>' for n in names) + "</html>")
    return names


def test_download_pipeline_over_file_uri(tmp_path):
    """Index -> filter -> fetch -> md5 -> untar -> resume, through the CLI
    and then download_entity, on a file:// mirror; JAX's select_files and
    parse_index_html agree."""
    entity, exp = "5067077", "SEN_test_sentence"
    names = _mirror(tmp_path, entity, exp)
    cfg_path = tmp_path / "download_dataset.json"
    cfg_path.write_text(json.dumps({
        "entity": [entity], "image": True, "mesh": True, "texture": False,
        "metadata": True, "audio": False, "expression": [exp]}))
    cfg = mf.parse_download_config(cfg_path)
    assert cfg == j_mf.parse_download_config(cfg_path)
    html = (tmp_path / "mirror" / entity / "index.html").read_text()
    assert mf.parse_index_html(html) == j_mf.parse_index_html(html) == names
    kept = mf.select_files(names, cfg)
    assert kept == j_mf.select_files(names, cfg)
    assert kept == [f"--images--{exp}--cam1.tar", "metadata.tar", "CHECKSUM",
                    "index.html"]
    dest = tmp_path / "dest"
    root = (tmp_path / "mirror").as_uri() + "/"
    mf.main(["--dest", str(dest), "--download-config", str(cfg_path),
             "--root", root])
    assert (dest / f"{entity}--images--{exp}--cam1" / "img.bin").exists()
    assert (dest / "metadata" / "meta.bin").read_bytes() == b"meta"
    assert not list(dest.glob("*.tar"))
    assert len(list(dest.glob("*.tar.unzip"))) == 2
    got, failed = mf.download_entity(dest, entity, cfg, root=root)
    assert got == [] and failed == []
    chk = mf.parse_checksum_file(dest / f"{entity}CHECKSUM")
    assert chk == j_mf.parse_checksum_file(dest / f"{entity}CHECKSUM")


def test_md5_verify_and_retries(tmp_path):
    """A corrupt fetch is retried until its md5 holds; a fetch that never
    gives the right bytes, or raises, is tried max_try times and reported."""
    good = b"payload"
    md5 = hashlib.md5(good).hexdigest()
    calls = []

    def flaky(url, out):          # corrupt twice, then right
        calls.append(url)
        out.write_bytes(good if len(calls) > 2 else b"garbage")

    assert mf.verify_or_download([("a.bin", "u", md5)], tmp_path,
                                 fetch=flaky) == []
    assert len(calls) == 3 and mf.md5sum(tmp_path / "a.bin") == md5
    assert mf.verify_or_download([("a.bin", "u", md5)], tmp_path) == []

    def broken(url, out):
        calls.append(url)
        raise OSError("unreachable")

    calls.clear()
    entry = ("b.bin", "v", md5)
    assert mf.verify_or_download([entry], tmp_path, fetch=broken,
                                 max_try=4) == [entry]
    assert len(calls) == 4
    calls.clear()
    assert mf.verify_or_download([entry], tmp_path, fetch=broken) == [entry]
    assert len(calls) == mf.MAX_TRY == 50
    assert mf.verify_or_download([("c.bin", "w", None)], tmp_path) == [
        ("c.bin", "w", None)]


def _tar_with(path, info, data=b""):
    with tarfile.open(path, "w") as tf:
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))
    return path


@pytest.mark.parametrize("kind", ["sibling", "symlink", "hardlink"])
def test_extract_tar_refuses_unsafe_members(tmp_path, kind):
    """A sibling-prefix path (<dest>-evil/, which a startswith check would
    pass), a symlink and a hardlink member are refused before anything is
    written; a benign tar extracts and leaves its .unzip marker."""
    dest = tmp_path / "MULTIFACE"
    dest.mkdir()
    if kind == "sibling":
        info, match = tarfile.TarInfo("../MULTIFACE-evil/x"), "unsafe"
    else:
        info, match = tarfile.TarInfo("out"), "link tar member"
        info.type = tarfile.SYMTYPE if kind == "symlink" else tarfile.LNKTYPE
        info.linkname = "../../etc/passwd"
    bad = _tar_with(tmp_path / "bad.tar", info, b"x" if kind == "sibling"
                    else b"")
    with pytest.raises(ValueError, match=match):
        mf.extract_tar(bad, dest)
    assert not (tmp_path / "MULTIFACE-evil").exists()
    assert not list(dest.iterdir())
    assert not (tmp_path / "bad.tar.unzip").exists()
    good = _tar_with(tmp_path / "good.tar", tarfile.TarInfo("sub/f.txt"),
                     b"ok")
    mf.extract_tar(good, dest)
    assert (dest / "sub" / "f.txt").read_bytes() == b"ok"
    assert (tmp_path / "good.tar.unzip").exists()


def test_preprocessing_runs_on_cuda_unless_told_otherwise(tmp_path,
                                                          monkeypatch):
    """The preprocessing entry points default to the CUDA device and raise
    without one; --device cpu runs them. Nothing falls back to the CPU."""
    align = _raw_subject(tmp_path / "raw")
    (tmp_path / "align.json").write_text(json.dumps(align))
    pose, verts, faces = _calib_pose(tmp_path)
    mesh = tmp_path / "grid.ply"
    mesh.write_text(
        "ply\nformat ascii 1.0\n"
        f"element vertex {len(verts)}\nproperty float x\nproperty float y\n"
        f"property float z\nelement face {len(faces)}\n"
        "property list uchar int vertex_indices\nend_header\n"
        + "".join(f"{x} {y} {z}\n" for x, y, z in verts)
        + "".join(f"3 {a} {b} {c}\n" for a, b, c in faces))
    pipe = ["--dir-in", str(tmp_path / "raw"), "--dir-out",
            str(tmp_path / "out"), "--align-json", str(tmp_path / "align.json"),
            "--crop-out", "32"]
    calib = ["--pose-dir", str(pose), "--mesh", str(mesh)]
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            facescape_pipeline.main(pipe)
        with pytest.raises(RuntimeError, match="CUDA"):
            color_calib.main(calib)
        for fn, args in (
                (render_depth, _case("quad")),
                (color_calib.vertex_visibility, _case("quad")),
                (mf.render_frame, (verts, faces, {"intrin": QUAD_K,
                                                  "extrin": np.eye(4)[:3]},
                                   8, 8))):
            with pytest.raises(RuntimeError, match="CUDA"):
                fn(*args)
        assert not (tmp_path / "out").exists()
        assert not (pose / "view_00000" / "rgba_colorcalib.png").exists()
    assert facescape_pipeline.main(pipe + ["--device", "cpu"]) == 0
    assert (tmp_path / "out" / "1" / "cameras.json").exists()
    assert color_calib.main(calib + ["--device", "cpu"]) == 0
    assert (pose / "view_00001" / "rgba_colorcalib.png").exists()
