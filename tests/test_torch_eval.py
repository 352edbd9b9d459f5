"""diner_tpu_torch's config builder, Lightning checkpoint map and bulk eval
against diner_tpu on the CPU.

- the YAML loader returns what yaml.safe_load returns, for every config;
- build_nerf / build_render_cfg give the JAX builders' arguments;
- from_lightning equals from_jax(port_diner_checkpoint(...)) bitwise, and
  to_lightning equals export_diner bitwise and round-trips;
- metrics, colormap, PNG files, prediction folders and folder reports equal
  the JAX package's (the PNGs decode to the same pixels, the scores to the
  same floats);
- render_eval runs end to end on the CPU from a fake reference checkpoint.
"""

import dataclasses
import json
import struct
import sys
import zlib
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest
import torch
import yaml

from diner_tpu.cli.build import (build_nerf as j_build_nerf,
                                 build_render_cfg as j_build_render_cfg)
from diner_tpu.eval import metrics as j_metrics
from diner_tpu.eval.predict import (
    create_prediction_folder as j_create_prediction_folder)
from diner_tpu.eval.suite import evaluate_folder as j_evaluate_folder
from diner_tpu.image_ops.colormap import colormap as j_colormap
from diner_tpu.models.torch_port import export_diner, port_diner_checkpoint
from diner_tpu_torch.cli.build import build_nerf, build_render_cfg, nerf_kwargs
from diner_tpu_torch.core.config import load_config
from diner_tpu_torch.data import SyntheticSphereDataset
from diner_tpu_torch.eval import metrics
from diner_tpu_torch.eval.predict import create_prediction_folder
from diner_tpu_torch.eval.suite import evaluate_folder
from diner_tpu_torch.image_ops.colormap import colormap
from diner_tpu_torch.image_ops.png import read_png, write_png
from diner_tpu_torch.models import (DINER, PixelNeRF, from_jax,
                                    from_lightning, to_lightning)
from diner_tpu_torch.serve import RenderServer

sys.path.insert(0, str(Path(__file__).parent))
from test_model_port import _fake_lightning_sd  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted((REPO / "configs").rglob("*.yaml"))
EVAL_CONFIGS = sorted((REPO / "configs").glob("evaluate_*.yaml"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_load_config_is_yaml_safe_load(path):
    with open(path) as f:
        ref = yaml.safe_load(f)
    assert load_config(path) == ref
    if path.name == "train_synthetic.yaml":   # YAML 1.1: 1e-3 is a string
        assert load_config(path)["optimizer"]["kwargs"]["lr"] == "1e-3"


@pytest.mark.parametrize("path", EVAL_CONFIGS, ids=lambda p: p.stem)
def test_builders_match_jax(path):
    """Every PixelNeRF argument the port's builder sets equals the JAX
    model's field; the RenderConfigs are equal field for field, the port's
    extra `likelihood` at its default "v1"."""
    conf = load_config(path)
    jm = j_build_nerf(conf["nerf"])
    kw = nerf_kwargs(conf["nerf"])
    assert {k: getattr(jm, k) for k in kw} == kw
    assert isinstance(build_nerf(conf["nerf"]), PixelNeRF)
    got = dataclasses.asdict(build_render_cfg(conf["renderer"]))
    assert got.pop("likelihood") == "v1"
    assert got == dataclasses.asdict(j_build_render_cfg(conf["renderer"]))


def test_render_cfg_reads_likelihood():
    cfg = build_render_cfg({"kwargs": {"n_prior_anchors": 8,
                                       "likelihood": "chord"}})
    assert cfg.likelihood == "chord"
    with pytest.raises(ValueError, match="likelihood"):
        build_render_cfg({"kwargs": {"likelihood": "fast"}})


def test_from_preset_builds_the_fast_preset():
    """RenderServer.from_preset on the certified DTU preset: the preset's
    render config and model, and its 4096-ray chunks."""
    path = REPO / "configs" / "evaluate_diner_on_dtu_fast.yaml"
    torch.manual_seed(0)
    server = RenderServer.from_preset(path, None, 1.0, 3.5, device="cpu")
    conf = load_config(path)
    assert server.cfg == build_render_cfg(conf["renderer"])
    assert server.chunk == 4096
    assert server.model.latent_quant == "int8"
    sd = server.model.state_dict()
    again = RenderServer.from_preset(path, sd, 1.0, 3.5, chunk=512,
                                     device="cpu")
    assert again.chunk == 512
    assert all(torch.equal(sd[k], v)
               for k, v in again.model.state_dict().items())


def test_from_lightning_matches_jax_port_bitwise():
    sd = _fake_lightning_sd()
    ported, jextras = port_diner_checkpoint(sd)
    ref = from_jax(ported["params"], ported["batch_stats"])
    got, extras = from_lightning(sd)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k
    assert extras == {k: jextras[k] for k in extras}
    assert extras["conv1_in_channels"] == 21


def test_to_lightning_matches_jax_export_and_round_trips():
    sd = _fake_lightning_sd()
    port_sd, extras = from_lightning(sd)
    model = DINER(PixelNeRF(encoder_norm="batch", sigma_activation="relu"),
                  znear=extras["znear"], zfar=extras["zfar"])
    model.nerf.load_state_dict(port_sd)
    out = to_lightning(model)
    ref = export_diner(port_diner_checkpoint(sd)[0], extras["znear"],
                       extras["zfar"])
    assert out.keys() == ref.keys()
    for k, v in ref.items():
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(v), k)
        assert out[k].numpy().dtype == np.asarray(v).dtype, k
    back, _ = from_lightning(out)
    assert all(torch.equal(back[k], v) for k, v in port_sd.items())


def _images(seed, n=3, H=23, W=31):
    rng = np.random.RandomState(seed)
    base = rng.rand(n, H, W, 3).astype(np.float32)
    return base, np.clip(base + rng.randn(n, H, W, 3).astype(np.float32)
                         * 0.05, 0, 1)


def test_metrics_match_jax():
    preds, gts = _images(0)
    for p, g in zip(preds, gts):
        for name in ("mse", "l1", "psnr"):
            assert getattr(metrics, name)(p, g) == getattr(j_metrics, name)(
                p, g)
        assert metrics.ssim(p, g) == j_metrics.ssim(p, g)
        assert metrics.ssim(p[..., 0], g[..., 0]) == j_metrics.ssim(
            p[..., 0], g[..., 0])
    assert metrics.psnr(preds[0], preds[0]) == float("inf")


def test_colormap_matches_matplotlib():
    """The carried viridis table with matplotlib's nearest-entry lookup:
    bitwise the JAX package's matplotlib colormap, constant images and
    out-of-range vmin/vmax included."""
    rng = np.random.RandomState(2)
    x = rng.rand(2, 9, 11, 1) * 3.0 - 1.0
    x[1] = 0.5
    np.testing.assert_array_equal(colormap(x), j_colormap(x))
    np.testing.assert_array_equal(colormap(x, vmin=-0.5, vmax=1.2),
                                  j_colormap(x, vmin=-0.5, vmax=1.2))


def _filtered_png(path, img):
    """An RGB PNG whose rows cycle through all five filter types."""
    H, W, C = img.shape
    raw = img.reshape(H, W * C).astype(np.int64)
    rows = []
    for y in range(H):
        kind = y % 5
        cur = raw[y]
        up = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(C, np.int64), cur[:-C]])
        ul = np.concatenate([np.zeros(C, np.int64), up[:-C]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        rows.append(bytes([kind]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(b"".join(rows)))
        + chunk(b"IEND", b""))


def test_png_round_trip_and_imageio_agreement(tmp_path):
    rng = np.random.RandomState(3)
    rgb = rng.randint(0, 256, (17, 21, 3)).astype(np.uint8)
    for img in (rgb, rgb[..., 0], np.concatenate([rgb, rgb[..., :1]], -1)):
        write_png(tmp_path / "a.png", img)
        np.testing.assert_array_equal(read_png(tmp_path / "a.png"), img)
        np.testing.assert_array_equal(imageio.imread(tmp_path / "a.png"), img)
        imageio.imwrite(tmp_path / "b.png", img)
        np.testing.assert_array_equal(read_png(tmp_path / "b.png"), img)
    _filtered_png(tmp_path / "c.png", rgb)
    np.testing.assert_array_equal(imageio.imread(tmp_path / "c.png"), rgb)
    np.testing.assert_array_equal(read_png(tmp_path / "c.png"), rgb)


def _fake_render(batch, seed):
    rng = np.random.RandomState(seed)
    SB, H, W, _ = batch["target_rgb"].shape
    return (np.clip(batch["target_rgb"]
                    + rng.randn(SB, H, W, 3).astype(np.float32) * 0.1, 0, 1),
            rng.rand(SB, H, W).astype(np.float32) + 1.0)


def test_prediction_folder_and_reports_match_jax(tmp_path):
    """Both packages write a prediction folder of the same renders and
    score it: the PNGs decode to the same pixels, and the JAX package's
    scoring of either folder gives the port's reports."""
    ds = SyntheticSphereDataset(n_scenes=3, n_views=2, H=24, W=32, seed=4)
    port = create_prediction_folder(_fake_render, ds, tmp_path / "port",
                                    n_samples=2)
    jdir = j_create_prediction_folder(_fake_render, ds, tmp_path / "jax",
                                      n_samples=2)
    names = sorted(p.name for p in port.iterdir())
    assert names == sorted(p.name for p in jdir.iterdir())
    assert len(names) == 8
    for n in names:
        np.testing.assert_array_equal(read_png(port / n),
                                      imageio.imread(jdir / n))
    scores = evaluate_folder(port, tmp_path / "port_out")
    ref = j_evaluate_folder(port, tmp_path / "jax_out")
    assert scores == ref
    for name in ("average_scores.json", "detailed_report.json"):
        assert (json.loads((tmp_path / "port_out" / name).read_text())
                == json.loads((tmp_path / "jax_out" / name).read_text()))
    np.testing.assert_array_equal(
        read_png(tmp_path / "port_out" / "examples.png"),
        imageio.imread(tmp_path / "jax_out" / "examples.png"))
    assert evaluate_folder(jdir, tmp_path / "jdir_out") == ref


def test_render_eval_end_to_end_on_cpu(tmp_path, capsys):
    """render_eval --device cpu from a fake reference checkpoint on a tiny
    synthetic config with the wrong norm and activation, which it forces
    (tests/test_cli.py's --torch-ckpt case), then eval_folder score."""
    from diner_tpu_torch.cli import eval_folder, render_eval

    sd = {k: torch.as_tensor(np.asarray(v))
          for k, v in _fake_lightning_sd().items()}
    torch.save({"state_dict": sd}, tmp_path / "fake.ckpt")
    conf = {
        "data": {"val": {"dataset": {
            "module": "SyntheticSphereDataset",
            "kwargs": {"n_scenes": 2, "n_views": 2, "H": 32, "W": 32,
                       "seed": 7}}}},
        "nerf": {"kwargs": {
            "sigma_activation": "softplus",
            "encoder_conf": {"kwargs": {"num_layers": 4, "norm": "group",
                                        "image_padding": 64,
                                        "padding_pe": 4}},
            "poscode_conf": {"kwargs": {"num_freqs": 6,
                                        "freq_factor": 6.28}},
            "mlp_fine_conf": {"kwargs": {"n_blocks": 5, "d_hidden": 512,
                                         "combine_layer": 3}}}},
        "renderer": {"kwargs": {"n_samples": 6, "n_depth_candidates": 32,
                                "n_gaussian": 2}},
    }
    (tmp_path / "eval.yaml").write_text(yaml.safe_dump(conf))
    out = tmp_path / "out"
    scores = render_eval.main([
        "--config", str(tmp_path / "eval.yaml"), "--torch-ckpt",
        str(tmp_path / "fake.ckpt"), "--out", str(out), "--n", "1",
        "--device", "cpu"])
    assert "forces {'encoder_norm': 'batch', 'sigma_activation': 'relu'}" \
        in capsys.readouterr().out
    assert np.isfinite(list(scores.values())).all()
    assert len(list((out / "visualizations").iterdir())) == 4
    assert json.loads((out / "average_scores.json").read_text()) == scores
    assert eval_folder.main(["score", str(out)]) == 0
    conf["nerf"]["kwargs"]["encoder_conf"]["kwargs"]["padding_pe"] = 2
    (tmp_path / "eval.yaml").write_text(yaml.safe_dump(conf))
    with pytest.raises(SystemExit, match="conv1 has 21 input channels"):
        render_eval.main(["--config", str(tmp_path / "eval.yaml"),
                          "--torch-ckpt", str(tmp_path / "fake.ckpt"),
                          "--out", str(out), "--device", "cpu"])
