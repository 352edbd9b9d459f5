"""diner_tpu_torch's dataset readers, codecs, collate, cam sweeps and the
training loop's batch order against diner_tpu on the CPU.

The fake DTU, FaceScape and MultiFace trees come from the JAX package's own
reader tests. Each reader's samples must equal the JAX reader's bitwise,
its sweep extrinsics within 1e-5; files written by one package's codecs
are read by the other's bitwise; the meta caches are interchangeable.
The slice as a whole: cli/build.py's functions give JAX's batch order, a DTU
sample renders as JAX renders it, create_cam_sweep writes what JAX's
writes, and the trainer sees JAX's batches at JAX's steps at any --seed.
"""

import json
import sys
from pathlib import Path

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from diner_tpu.cli import build as j_build
from diner_tpu.core.types import RenderConfig as JRenderConfig
from diner_tpu.data import codecs as j_codecs
from diner_tpu.data.contract import collate as j_collate
from diner_tpu.data.contract import to_device_batch as j_to_device_batch
from diner_tpu.data.dtu import DTUDataset as JDTU
from diner_tpu.data.facescape import FacescapeDataset as JFacescape
from diner_tpu.data.loader import BatchLoader as JBatchLoader
from diner_tpu.data.multiface import MultiFaceDataset as JMultiFace
from diner_tpu.eval import sweep as j_sweep
from diner_tpu.models import PixelNeRF as JPixelNeRF
from diner_tpu.models.diner import DINER as JDINER
from diner_tpu.train import loop as j_loop
from diner_tpu_torch.cli import build
from diner_tpu_torch.cli import train as train_cli
from diner_tpu_torch.core import RenderConfig
from diner_tpu_torch.core.config import resolve
from diner_tpu_torch.data import BatchLoader, codecs, collate, to_device_batch
from diner_tpu_torch.data.dtu import DTUDataset
from diner_tpu_torch.data.facescape import FacescapeDataset
from diner_tpu_torch.data.multiface import MultiFaceDataset
from diner_tpu_torch.eval import sweep
from diner_tpu_torch.models import DINER, PixelNeRF, from_jax
from diner_tpu_torch.train import loop

sys.path.insert(0, str(Path(__file__).parent))
from test_data import _make_fake_dtu  # noqa: E402
from test_facescape import _make_fake_facescape  # noqa: E402
from test_multiface import _make_fake_multiface  # noqa: E402
from test_torch_eval import _filtered_png  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "fastpath_tiny.npz"
CAM, LIGHT = 3, 2                  # a DTU target beyond cam 0, light 0
DTU_IDX = (0, CAM * 7 + LIGHT)     # metas run scan x cam x light


def assert_samples_equal(got, ref):
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert type(got[k]) is type(v) and got[k] == v, k


@pytest.fixture(scope="module")
def dtu(tmp_path_factory):
    """(root, split_dir): the JAX tests' fake DTU tree, plus the images of
    target cam CAM and its source cams at light LIGHT."""
    root = tmp_path_factory.mktemp("dtu")
    split_dir = _make_fake_dtu(root)
    rng = np.random.RandomState(1)
    img_dir = root / "Rectified" / "scan1_train"
    for cam in (CAM, *DTUDataset.SRC_CAM_IDCS):
        Image.fromarray(rng.randint(0, 255, (512, 640, 3), dtype=np.uint8)
                        ).save(img_dir / f"rect_{cam + 1:03d}_{LIGHT}_r5000.png")
    return root, split_dir


@pytest.fixture(scope="module")
def facescape(tmp_path_factory):
    root = tmp_path_factory.mktemp("facescape")
    _make_fake_facescape(root)
    return root


@pytest.fixture(scope="module")
def multiface(tmp_path_factory):
    """(root, split_config, JAX meta_dir, port meta_dir); the depth folders
    also hold confidence PNGs for the depth_std_suffix branch."""
    root = tmp_path_factory.mktemp("mf")
    j_meta = tmp_path_factory.mktemp("mf_meta_jax")
    root, cfg = _make_fake_multiface(root, j_meta)
    rng = np.random.RandomState(2)
    for d in root.glob("*/depths/*/*/000001.png"):
        codecs.write_png16(d.with_name("000001_conf.png"),
                           rng.randint(0, 12000, (128, 160)))
    return root, cfg, j_meta, tmp_path_factory.mktemp("mf_meta_port")


def test_registry_resolves_the_readers():
    for name, cls in (("DTUDataset", DTUDataset), ("DTUDataSet", DTUDataset),
                      ("FacescapeDataset", FacescapeDataset),
                      ("FacescapeDataSet", FacescapeDataset),
                      ("MultiFaceDataset", MultiFaceDataset),
                      ("src.data.dtu.DTUDataSet", DTUDataset)):
        assert resolve(name) is cls, name


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_codecs_read_what_the_other_package_writes(tmp_path, writer):
    """16-bit PNGs (also imageio's, which filters its rows adaptively),
    depth PNGs, PFMs and MVSNet cams, bitwise."""
    w, r = (j_codecs, codecs) if writer == "jax" else (codecs, j_codecs)
    rng = np.random.RandomState(3)
    img = rng.randint(0, 65536, (37, 53)).astype(np.uint16)
    w.write_png16(tmp_path / "a.png", img)
    got = r.read_png16(tmp_path / "a.png")
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(imageio.imread(tmp_path / "a.png"), img)
    imageio.imwrite(tmp_path / "b.png", img)
    np.testing.assert_array_equal(r.read_png16(tmp_path / "b.png"), img)

    depth = rng.rand(19, 23).astype(np.float32) * 5
    depth[0, :3] = 0
    w.write_depth_png(tmp_path / "d.png", depth)
    np.testing.assert_array_equal(r.read_depth_png(tmp_path / "d.png"),
                                  j_codecs.read_depth_png(tmp_path / "d.png"))
    for arr in (rng.rand(13, 17).astype(np.float32),
                rng.rand(7, 9, 3).astype(np.float32)):
        w.write_pfm(tmp_path / "x.pfm", arr, scale=2.0)
        back, scale = r.read_pfm(tmp_path / "x.pfm")
        assert back.dtype == np.float32 and scale == 2.0
        np.testing.assert_array_equal(back, arr)

    ext = np.eye(4, dtype=np.float32)
    ext[:3] = rng.randn(3, 4)
    K = np.array([[361.5, 0, 82.25], [0, 360.125, 66.0], [0, 0, 1]])
    w.write_mvsnet_cam(tmp_path / "c_cam.txt", ext, K, 425.0, 2.5)
    got = r.read_mvsnet_cam(tmp_path / "c_cam.txt")
    ref = j_codecs.read_mvsnet_cam(tmp_path / "c_cam.txt")
    for g, e in zip(got[:2], ref[:2]):
        assert g.dtype == e.dtype
        np.testing.assert_array_equal(g, e)
    assert got[2] == ref[2] == (425.0, 2.5)
    for h, wd in ((5, 7), (64, 80)):
        np.testing.assert_array_equal(codecs.nearest_resize(depth, h, wd),
                                      j_codecs.nearest_resize(depth, h, wd))


@pytest.mark.parametrize("kinds", [(0, 1, 2, 3, 4), (4,), (3,), (5,)],
                         ids=["all", "paeth", "average", "unknown"])
def test_png16_row_filters_decode_as_imageio(tmp_path, kinds):
    """Every row filter on 16-bit grey rows, whose left neighbour is two
    bytes back, decodes as imageio and the JAX codec decode it; an unknown
    filter type raises."""
    rng = np.random.RandomState(4)
    img = rng.randint(0, 65536, (23, 31)).astype(np.uint16)
    img[5:9] = img[4]           # runs, and small values whose
    img[12:20] = rng.randint(0, 8, (8, 31))   # predictors tie
    img[:, 7] = 0
    path = tmp_path / "f.png"
    _filtered_png(path, img, kinds)
    if kinds == (5,):
        with pytest.raises(ValueError, match="unknown PNG row filter 5"):
            codecs.read_png16(path)
        return
    np.testing.assert_array_equal(imageio.imread(path), img)
    np.testing.assert_array_equal(codecs.read_png16(path), img)
    np.testing.assert_array_equal(j_codecs.read_png16(path), img)


@pytest.mark.parametrize("idx", DTU_IDX)
def test_dtu_samples_match_jax(dtu, idx):
    root, split_dir = dtu
    ds = DTUDataset(root, stage="train", split_dir=split_dir)
    jds = JDTU(root, stage="train", split_dir=split_dir)
    assert ds.metas == jds.metas and ds.cam_ids == jds.cam_ids
    assert (ds.znear, ds.zfar) == (jds.znear, jds.zfar)
    s = ds[idx]
    assert (s["target_view_id"], s["light_idx"]) == divmod(idx, 7)
    assert_samples_equal(s, jds[idx])


def test_dtu_pfm_depth_and_full_resolution_match_jax(dtu, tmp_path):
    """The PFM branch (1200x1600 GT depth: 1/2 nearest, then the 512x640
    crop) at downsample 0.5, and a sample at downsample 1."""
    root, split_dir = dtu
    depth = np.random.RandomState(4).rand(1200, 1600).astype(np.float32)
    depth *= 900
    codecs.write_pfm(tmp_path / "gt.pfm", depth)
    ds = DTUDataset(root, split_dir=split_dir)
    jds = JDTU(root, split_dir=split_dir)
    for got, ref in zip(ds._read_depth(tmp_path / "gt.pfm"),
                        jds._read_depth(tmp_path / "gt.pfm")):
        assert got.shape == ref.shape == (256, 320, 1)
        np.testing.assert_array_equal(got, ref)
    ds1 = DTUDataset(root, split_dir=split_dir, downsample=1.0)
    s = ds1[0]
    assert s["target_rgb"].shape == (512, 640, 3)
    assert_samples_equal(s, JDTU(root, split_dir=split_dir,
                                 downsample=1.0)[0])


def test_dtu_check_depth_existence_raises_on_a_missing_conf(dtu):
    root, split_dir = dtu
    ds = DTUDataset(root, split_dir=split_dir)
    jds = JDTU(root, split_dir=split_dir)
    ds.check_depth_existence()
    conf = (root / "Depths" / "scan1" /
            "depth_map_0030_TransMVSNet_conf.png")
    moved = conf.with_name("moved.png")
    conf.rename(moved)
    try:
        with pytest.raises(FileNotFoundError) as got:
            ds.check_depth_existence()
        with pytest.raises(FileNotFoundError) as ref:
            jds.check_depth_existence()
    finally:
        moved.rename(conf)
    assert got.value.args[1] == ref.value.args[1]
    assert set(got.value.args[1]) == {conf}


def _lookat(eye):
    z = -eye / np.linalg.norm(eye)
    x = np.cross([0.0, -1.0, 0.0], z)
    x /= np.linalg.norm(x)
    ext = np.eye(4, dtype=np.float32)
    ext[:3, :3] = np.stack([x, np.cross(z, x), z])
    ext[:3, 3] = -ext[:3, :3] @ eye
    return ext


@pytest.mark.parametrize("cams", ["tree", "arc"])
def test_dtu_cam_sweep_matches_jax(dtu, cams):
    """On the tree's cameras (parallel axes) and on 49 cameras on an arc
    looking at the origin."""
    root, split_dir = dtu
    ds = DTUDataset(root, stage="val", split_dir=split_dir)
    jds = JDTU(root, stage="val", split_dir=split_dir)
    if cams == "arc":
        a = np.linspace(-0.8, 0.8, 49)
        exts = np.stack([_lookat(np.array([np.sin(t), 0.2 * np.cos(3 * t),
                                           -np.cos(t)]) * 0.6) for t in a])
        ds.extrinsics = jds.extrinsics = exts
    got, ref = ds.get_cam_sweep_extrinsics(7), jds.get_cam_sweep_extrinsics(7)
    assert got.dtype == ref.dtype == np.float32 and got.shape == (7, 4, 4)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def _facescape_pair(root, j_meta, t_meta, **kw):
    kw = dict(stage="val", val_subjects=["001"], **kw)
    return (FacescapeDataset(root, meta_dir=t_meta, **kw),
            JFacescape(root, meta_dir=j_meta, **kw))


def test_facescape_metas_and_cache_match_jax(facescape, tmp_path):
    """Equal metas; the cache files have the same name and bytes, and each
    package reads the other's without generating."""
    j_meta, t_meta = tmp_path / "jax", tmp_path / "port"
    ds, jds = _facescape_pair(facescape, j_meta, t_meta)
    assert len(ds.metas) > 4 and ds.metas == jds.metas
    files = sorted(p.name for p in t_meta.iterdir())
    assert files == sorted(p.name for p in j_meta.iterdir())
    assert all((t_meta / f).read_bytes() == (j_meta / f).read_bytes()
               for f in files)

    def refuse(self):
        raise AssertionError("generated metas despite a cache")

    (t_meta / files[0]).write_text(json.dumps(ds.metas[:3], indent="\t"))
    orig = (FacescapeDataset._generate_metas, JFacescape._generate_metas)
    FacescapeDataset._generate_metas = JFacescape._generate_metas = refuse
    try:
        swapped = _facescape_pair(facescape, t_meta, j_meta)
    finally:
        FacescapeDataset._generate_metas, JFacescape._generate_metas = orig
    assert swapped[0].metas == jds.metas and swapped[1].metas == ds.metas[:3]


@pytest.mark.parametrize("random_ref_views", [False, True])
def test_facescape_samples_match_jax(facescape, tmp_path, random_ref_views):
    """Every sample, bitwise; with random_ref_views each index drawn twice
    (a visit redraws) at the same seed."""
    ds, jds = _facescape_pair(facescape, tmp_path / "j", tmp_path / "t",
                              random_ref_views=random_ref_views, seed=3)
    visits = 2 if random_ref_views else 1
    for idx in range(len(ds)):
        for _ in range(visits):
            assert_samples_equal(ds[idx], jds[idx])


def test_facescape_cam_sweep_matches_jax(facescape, tmp_path):
    ds, jds = _facescape_pair(facescape, tmp_path / "j", tmp_path / "t")
    for kw in ({}, {"elevation": 10.0, "sweep_range": 30.0}):
        got = ds.get_cam_sweep_extrinsics(5, scan_idx=1, **kw)
        ref = jds.get_cam_sweep_extrinsics(5, scan_idx=1, **kw)
        assert got.dtype == ref.dtype
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("downsample,std_suffix", [(4, None), (1, None),
                                                    (2, "_conf.png")])
def test_multiface_samples_match_jax(multiface, downsample, std_suffix):
    """Resized (the /32 alignment) and at full size; constant sigma and
    sigma from confidence PNGs."""
    root, cfg, j_meta, t_meta = multiface
    kw = dict(stage="val", downsample=downsample, split_config=cfg,
              depth_std_suffix=std_suffix)
    ds = MultiFaceDataset(root, meta_dir=t_meta, **kw)
    jds = JMultiFace(root, meta_dir=j_meta, **kw)
    assert len(ds) > 1 and ds.metas == jds.metas
    for idx in (0, len(ds) - 1):
        assert_samples_equal(ds[idx], jds[idx])


def test_multiface_cache_and_cam_sweep_match_jax(multiface):
    root, cfg, j_meta, t_meta = multiface
    kw = dict(stage="val", downsample=4, split_config=cfg)
    ds = MultiFaceDataset(root, meta_dir=t_meta, **kw)
    jds = JMultiFace(root, meta_dir=j_meta, **kw)
    name = "val_tiny_subset.txt"
    assert (t_meta / name).read_bytes() == (j_meta / name).read_bytes()
    assert MultiFaceDataset(root, meta_dir=j_meta, **kw).metas == ds.metas
    got = ds.get_cam_sweep_extrinsics(6, scan_idx=0)
    ref = jds.get_cam_sweep_extrinsics(6, scan_idx=0)
    assert got.dtype == ref.dtype and got.shape == (6, 4, 4)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_collate_keeps_numeric_scalars_as_jax_does(dtu, facescape, tmp_path):
    """The readers' bookkeeping ints (target_view_id, light_idx, scan_idx)
    are stacked, names listed: keys, dtypes and values as JAX's collate."""
    root, split_dir = dtu
    ds = DTUDataset(root, split_dir=split_dir)
    fs = FacescapeDataset(facescape, stage="val", val_subjects=["001"],
                          meta_dir=tmp_path)
    for samples in ([ds[i] for i in DTU_IDX], [fs[0], fs[1]]):
        got, ref = collate(samples), j_collate(samples)
        assert got.keys() == ref.keys()
        for k, v in ref.items():
            if isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype, k
                np.testing.assert_array_equal(got[k], v)
            else:
                assert got[k] == v, k
        assert to_device_batch(got).keys() == j_to_device_batch(ref).keys()
    assert collate([ds[DTU_IDX[1]]])["light_idx"].tolist() == [LIGHT]


class _Indexed:
    """A dataset of `n` samples that hold only their index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": np.int64(i), "sample_name": f"s{i}"}


def _order(loader, epochs=2):
    loader.dataset = _Indexed(len(loader.dataset))
    return [b["idx"].tolist() for _ in range(epochs) for b in loader]


def _dtu_conf(dtu, tmp_path):
    """train_synthetic.yaml with its data on the fake DTU tree."""
    root, split_dir = dtu
    conf = yaml.safe_load((REPO / "configs" / "train_synthetic.yaml")
                          .read_text())
    dset = {"module": "DTUDataset", "kwargs": {
        "root": str(root), "split_dir": str(split_dir)}}
    conf["data"] = {
        "train": {"dataset": dset, "dataloader": {"kwargs": {
            "batch_size": 4, "shuffle": True, "num_workers": 2}}},
        "val": {"dataset": dset}}
    path = tmp_path / "dtu.yaml"
    path.write_text(yaml.safe_dump(conf))
    return conf, path


def test_build_functions_give_jax_batch_order(dtu, tmp_path):
    conf, _ = _dtu_conf(dtu, tmp_path)
    ds = build.build_dataset(conf["data"]["train"], stage="train")
    jds = j_build.build_dataset(conf["data"]["train"], stage="train")
    assert isinstance(ds, DTUDataset) and ds.metas == jds.metas
    tl = build.build_loader(conf["data"]["train"], ds, True)
    jl = j_build.build_loader(conf["data"]["train"], jds, True)
    assert len(tl) == len(jl) == 343 // 4
    got, ref = _order(tl), _order(jl)
    assert got == ref and got[0] != got[len(tl)]   # reshuffled per epoch


def test_train_cli_shuffles_as_jax_at_any_seed(dtu, tmp_path, monkeypatch):
    """--seed seeds the model and the draws, not the loader: cli/train's
    loader at --seed 3 yields the JAX CLI's batches (whose build_loader
    never takes a seed) in their order."""
    conf, path = _dtu_conf(dtu, tmp_path)
    seen = {}

    def fake_train(model, loader, logdir, **kw):
        seen.update(loader=loader, seed=kw["seed"])

    monkeypatch.setattr(loop, "train", fake_train)
    train_cli.main([str(path), "--run-dir", str(tmp_path / "run"),
                    "--seed", "3", "--device", "cpu"])
    assert seen["seed"] == 3
    jds = j_build.build_dataset(conf["data"]["train"], stage="train")
    jl = j_build.build_loader(conf["data"]["train"], jds, True)
    assert _order(seen["loader"]) == _order(jl)


class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.nerf = torch.nn.Linear(1, 1)


class _JState:
    params = opt_state = None

    def replace(self, **kw):
        return self


@pytest.mark.parametrize("epoch_batches", [5, 2])
def test_train_steps_see_jax_batches(monkeypatch, tmp_path, epoch_batches):
    """Both loops on equal loaders, their steps stubbed to record the batch
    indices: the port's first three steps train on JAX's first three
    batches (JAX spends the first batch on initialization), also when the
    loader starts a new epoch inside them."""
    ds = _Indexed(2 * epoch_batches)
    seen = {"jax": [], "port": []}

    def j_step(state, batch, key):
        seen["jax"].append(np.asarray(batch["idx"]).tolist())
        return state, {}

    def t_step(state, batch, generator=None):
        seen["port"].append(batch["idx"].long().tolist())
        return {}

    monkeypatch.setattr(j_loop, "create_train_state",
                        lambda *a, **kw: _JState())
    monkeypatch.setattr(j_loop, "make_train_step", lambda model: j_step)
    monkeypatch.setattr(j_loop, "make_data_mesh_for_batch", lambda n: None)
    monkeypatch.setattr(j_loop, "replicate", lambda x, mesh: x)
    monkeypatch.setattr(j_loop, "global_batch", lambda b, mesh: b)
    monkeypatch.setattr(j_loop, "save_checkpoint", lambda *a: None)
    monkeypatch.setattr(j_loop, "MetricLogger", loop.MetricLogger)  # no TF
    monkeypatch.setattr(loop, "train_step", t_step)
    monkeypatch.setattr(loop, "save_checkpoint", lambda *a: None)
    j_loop.train(None, JBatchLoader(ds, 2, shuffle=True, num_threads=1),
                 tmp_path / "j", max_steps=3)
    loop.train(_Toy(), BatchLoader(ds, 2, shuffle=True, num_threads=1),
               tmp_path / "t", max_steps=3, device="cpu")
    assert len(seen["port"]) == 3 and seen["port"] == seen["jax"]


@pytest.fixture(scope="module")
def fixture_params():
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


def _psnr(a, b):
    return float(-10.0 * np.log10(max(np.mean((a - b) ** 2), 1e-20)))


def test_dtu_sample_renders_as_jax(dtu, fixture_params):
    """One DTU sample at downsample 1/8 (64x80) through the trained
    fixture's weights on the exact float32 path, JAX's draws passed to the
    port: the renders agree to 40 dB, as the synthetic scene's do."""
    root, split_dir = dtu
    params, meta = fixture_params
    ds = DTUDataset(root, split_dir=split_dir, downsample=0.125)
    batch = to_device_batch(collate([ds[DTU_IDX[1]]]))
    H, W = batch["target_rgb"].shape[1:3]
    assert (H, W) == (64, 80)
    rkw = dict(meta["render_kw"], n_prior_anchors=0)
    jm = JDINER(nerf=JPixelNeRF(**meta["model_kw"]),
                render_cfg=JRenderConfig(**rkw), znear=ds.znear,
                zfar=ds.zfar)
    key = jax.random.PRNGKey(0)
    rgb_j, depth_j = jax.jit(lambda v, b, r: jm.apply(
        v, b, r, method="render_batch"))(
            {"params": jax.tree_util.tree_map(jnp.asarray, params)},
            {k: jnp.asarray(v) for k, v in batch.items()}, key)
    cfg = RenderConfig(**rkw)
    chunk = cfg.eval_chunk_rays
    noise = []
    for k in jax.random.split(key, -(-H * W // chunk)):
        ks, kg, kf = jax.random.split(k, 3)
        noise.append(tuple(torch.from_numpy(np.array(x)) for x in (
            jax.random.uniform(ks, (1, chunk, cfg.n_depth_candidates)),
            jax.random.normal(kg, (1, chunk, cfg.n_gaussian)),
            jax.random.uniform(kf, (1, chunk, cfg.n_samples)))))
    tm = DINER(PixelNeRF(**meta["model_kw"]), cfg, znear=ds.znear,
               zfar=ds.zfar)
    tm.load_state_dict(from_jax(params))
    rgb_t, depth_t = tm.render_batch(batch, noise=noise, device="cpu")
    assert rgb_t.shape == (1, H, W, 3) and depth_t.shape == (1, H, W)
    assert np.all(np.isfinite(depth_t.numpy()))
    assert _psnr(np.clip(rgb_t.numpy(), 0, 1),
                 np.clip(np.asarray(rgb_j), 0, 1)) >= 40.0


def test_create_cam_sweep_writes_what_jax_writes(dtu, tmp_path, monkeypatch):
    """A stub render on two DTU samples: the same file names, and the same
    frames (rgb over viridis depth, played forward and back) handed to
    save_video in the same order."""
    root, split_dir = dtu
    ds = DTUDataset(root, stage="val", split_dir=split_dir, downsample=0.125)
    jds = JDTU(root, stage="val", split_dir=split_dir, downsample=0.125)

    def render(batch, target_ext, seed):
        H, W = batch["target_rgb"].shape[1:3]
        t = float(np.asarray(target_ext)[0, 0, 3])
        ramp = np.linspace(0, 1, H * W, dtype=np.float32).reshape(1, H, W)
        return (np.repeat(ramp[..., None], 3, -1) * (seed + 1) / 8,
                ramp * 2 + t + seed)

    videos = {"port": [], "jax": []}
    for name, mod in (("port", sweep), ("jax", j_sweep)):
        monkeypatch.setattr(mod, "save_video", lambda f, p, fps, n=name:
                            videos[n].append((Path(p).name, f, fps)))
    sweep.create_cam_sweep(render, ds, tmp_path / "t", nframes=4, fps=3,
                           sample_idcs=DTU_IDX)
    j_sweep.create_cam_sweep(render, jds, tmp_path / "j", nframes=4, fps=3,
                             sample_idcs=DTU_IDX)
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir())
    assert [v[0] for v in videos["port"]] == [v[0] for v in videos["jax"]] \
        == ["scan1-0.mp4", f"scan1-{CAM}.mp4"]
    for (_, f, fps), (_, jf, jfps) in zip(videos["port"], videos["jax"]):
        assert f.shape == (7, 128, 80, 3) and fps == jfps == 3
        np.testing.assert_allclose(f, jf, atol=1e-6, rtol=0)


def test_save_video_writes_jax_mp4_through_cv2_without_imageio(tmp_path,
                                                              monkeypatch):
    """Without imageio both packages fall back to cv2's mp4 writer, and their
    files decode to the same frames."""
    import cv2

    for name in ("imageio", "imageio.v2"):
        monkeypatch.setitem(sys.modules, name, None)
    frames = np.random.RandomState(5).rand(3, 32, 48, 3).astype(np.float32)
    sweep.save_video(frames, tmp_path / "port.mp4", fps=3)
    j_sweep.save_video(frames, tmp_path / "jax.mp4", fps=3)

    def decode(path):
        cap = cv2.VideoCapture(str(path))
        out = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            out.append(f)
        cap.release()
        return np.stack(out)

    got, ref = decode(tmp_path / "port.mp4"), decode(tmp_path / "jax.mp4")
    assert got.shape == (3, 32, 48, 3)
    np.testing.assert_array_equal(got, ref)
