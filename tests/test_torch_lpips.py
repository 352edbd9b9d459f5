"""diner_tpu_torch's LPIPS against diner_tpu's on the CPU.

Random weights in the pip lpips and torchvision layouts
(tests/test_lpips.py's `_fixture_state_dicts`) reach the JAX package
through `port_lpips_vgg` and the port through `from_state_dicts`, or
through the .npz that `save_lpips_npz` (scripts/port_lpips.py) writes and
the port's `load_lpips_npz` reads. Distances agree within 1e-5 abs at 64x64
(VGG16's convolutions summed in another order); the two weight paths give
the same tensors bitwise. Also: the lpips column of evaluate_folder, and
`eval_folder score --lpips` and `render_eval --lpips` on the CPU.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diner_tpu.eval.suite import evaluate_folder as j_evaluate_folder
from diner_tpu.nn.lpips import LpipsVgg as JLpipsVgg
from diner_tpu.nn.lpips import make_lpips_fn as j_make_lpips_fn
from diner_tpu.nn.lpips import port_lpips_vgg, save_lpips_npz
from diner_tpu_torch.cli import eval_folder, render_eval
from diner_tpu_torch.eval.suite import evaluate_folder
from diner_tpu_torch.image_ops.png import write_png
from diner_tpu_torch.nn.lpips import (LpipsVgg, from_state_dicts,
                                      load_lpips_npz, make_lpips_fn)
from test_lpips import _fixture_state_dicts

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The random state dicts, JAX's variables and the .npz, as
    scripts/port_lpips.py writes it (with its sha256 entries)."""
    lpips_sd, vgg_sd = _fixture_state_dicts(seed=7)
    variables = dict(port_lpips_vgg(lpips_sd, vgg_sd))
    path = tmp_path_factory.mktemp("lpips") / "lpips_vgg.npz"
    save_lpips_npz(dict(variables, _source_sha256={
        "vgg16": np.frombuffer(b"0123", np.uint8)}), path)
    return dict(lpips_sd=lpips_sd, vgg_sd=vgg_sd, variables=variables,
                npz=path)


def _images(seed, B=2, H=64, W=64):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, H, W, 3).astype(np.float32)
    y = np.clip(x + rng.randn(B, H, W, 3).astype(np.float32) * 0.1, 0, 1)
    return x, y


def test_lpips_vgg_matches_jax(weights):
    x, y = (a * 2 - 1 for a in _images(1))
    ref = np.asarray(jax.jit(lambda a, b: JLpipsVgg().apply(
        weights["variables"], a, b))(jnp.asarray(x), jnp.asarray(y)))
    model = LpipsVgg()
    model.load_state_dict(from_state_dicts(weights["lpips_sd"],
                                           weights["vgg_sd"]))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        same = model(torch.from_numpy(x), torch.from_numpy(x)).numpy()
    assert got.shape == (2,) and (got > 0).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(same, 0.0, atol=1e-6)


def test_npz_and_state_dict_paths_agree(weights):
    """load_lpips_npz (flax's keys, HWIO kernels; the sha256 entries
    skipped) and from_state_dicts (pip lpips's lin{i} or lins.{i} heads,
    torchvision's features.{idx}) give the same state_dict bitwise, which
    loads strictly into LpipsVgg."""
    sd = load_lpips_npz(weights["npz"])
    ref = from_state_dicts(weights["lpips_sd"], weights["vgg_sd"])
    renamed = {f"lins.{k[3]}.model.1.weight": v
               for k, v in weights["lpips_sd"].items()}
    assert sd.keys() == ref.keys() == LpipsVgg().state_dict().keys()
    for other in (ref, from_state_dicts(renamed, weights["vgg_sd"])):
        for k, v in sd.items():
            assert torch.equal(v, other[k]), k
    with pytest.raises(KeyError, match="lin head 4"):
        from_state_dicts({k: v for k, v in weights["lpips_sd"].items()
                          if not k.startswith("lin4")}, weights["vgg_sd"])


def test_make_lpips_fn_matches_jax(weights):
    """(pred, gt) HWC in [0, 1] -> float, as the JAX package's, on the CPU
    when asked; the card by default, which needs CUDA."""
    x, y = _images(2, B=1)
    fn = make_lpips_fn(load_lpips_npz(weights["npz"]), device="cpu")
    jfn = j_make_lpips_fn(weights["variables"])
    assert fn(x[0], y[0]) == pytest.approx(jfn(x[0], y[0]), abs=1e-5)


def _write_folder(root: Path, n=2, H=48, W=40):
    vis = root / "visualizations"
    vis.mkdir(parents=True)
    for i in range(n):
        pred, gt = _images(10 + i, B=1, H=H, W=W)
        write_png(vis / f"s{i}-pred.png", (pred[0] * 255).astype(np.uint8))
        write_png(vis / f"s{i}-gt.png", (gt[0] * 255).astype(np.uint8))
    return vis


def test_evaluate_folder_lpips_column_and_eval_folder_cli(weights, tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """evaluate_folder(lpips_fn=...) adds lpips to average_scores.json and
    to each row of detailed_report.json, as the JAX package's does (same
    PNGs, each package's LPIPS); `eval_folder score --lpips --device cpu`
    writes the same reports; without --device cpu it needs CUDA."""
    vis = _write_folder(tmp_path / "run")
    fn = make_lpips_fn(load_lpips_npz(weights["npz"]), device="cpu")
    scores = evaluate_folder(vis, tmp_path / "port", lpips_fn=fn)
    ref = j_evaluate_folder(vis, tmp_path / "jax", lpips_fn=j_make_lpips_fn(
        weights["variables"]))
    assert set(scores) == {"ssim", "psnr", "l2", "l1", "lpips"}
    for k, v in ref.items():
        assert scores[k] == pytest.approx(v, abs=1e-5), k
    rows = json.loads((tmp_path / "port" / "detailed_report.json")
                      .read_text())
    assert len(rows) == 2 and all("lpips" in r for r in rows)
    assert "lpips" not in evaluate_folder(vis, tmp_path / "plain")

    assert eval_folder.main(["score", str(tmp_path / "run"), "--lpips",
                             str(weights["npz"]), "--device", "cpu"]) == 0
    assert "lpips: " in capsys.readouterr().out
    avg = json.loads((tmp_path / "run" / "average_scores.json").read_text())
    assert avg["lpips"] == pytest.approx(scores["lpips"], abs=1e-7)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_folder.main(["score", str(tmp_path / "run"), "--lpips",
                          str(weights["npz"])])


def test_render_eval_lpips_on_cpu(weights, tmp_path):
    """render_eval --ckpt ... --lpips on train_synthetic.yaml's tiny model
    (random weights from seed 0, one val image): the scores hold lpips."""
    from diner_tpu_torch.cli.build import build_dataset, build_diner
    from diner_tpu_torch.core.config import load_config
    from diner_tpu_torch.train import ckpt_io

    cfg = REPO / "configs" / "train_synthetic.yaml"
    conf = load_config(cfg)
    val_set = build_dataset(conf["data"]["val"], stage="val")
    torch.manual_seed(0)
    model = build_diner(conf, znear=val_set.znear, zfar=val_set.zfar)
    ckpt_io.save(tmp_path / "ckpts", 0, {"nerf": model.nerf.state_dict(),
                                        "step": 0})
    scores = render_eval.main([
        "--config", str(cfg), "--ckpt", str(tmp_path / "ckpts"), "--out",
        str(tmp_path / "out"), "--n", "1", "--lpips", str(weights["npz"]),
        "--device", "cpu"])
    assert set(scores) == {"ssim", "psnr", "l2", "l1", "lpips"}
    assert all(np.isfinite(v) for v in scores.values())
