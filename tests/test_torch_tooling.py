"""diner_tpu_torch's offline tooling against diner_tpu on the CPU:
masked_downsample, eval/compare (and `eval_folder compare`),
utils/visualize, the cluster layer and `cli/submit`, `cli/export_torch
diner`.

Tolerances:
- masked_downsample: equal bit for bit (the same float32 pooling sums,
  divisions and nearest picks);
- compare and visualize: the same file names, and each PNG decoded to the
  same pixels (both packages draw with the same matplotlib on the same
  arrays); the CSV text equal;
- to_condor: the same text for the same JobSpec fields;
- export_torch: every tensor equal to JAX's export_diner bit for bit, and
  back through from_lightning equal to the checkpoint's.
"""

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from diner_tpu.cluster import JobSpec as JJobSpec
from diner_tpu.cluster import to_condor as j_to_condor
from diner_tpu.eval.compare import compare_evaluations as j_compare
from diner_tpu.eval.suite import EXAMPLE_PLOT_FILENAME, N_EXAMPLE_PLOTS
from diner_tpu.eval.suite import REPORT_DETAIL_FILENAME
from diner_tpu.image_ops import masked_downsample as j_masked_downsample
from diner_tpu.models.torch_port import export_diner, port_diner_checkpoint
from diner_tpu.utils import visualize as j_vis
from diner_tpu_torch.cli import eval_folder, export_torch, submit
from diner_tpu_torch.cli.build import build_nerf
from diner_tpu_torch.cluster import (SPECS, JobSpec, run_local, to_condor,
                                     to_jobset)
from diner_tpu_torch.cluster.jobs import gpu_request
from diner_tpu_torch.core.config import load_config
from diner_tpu_torch.data import SyntheticSphereDataset
from diner_tpu_torch.eval.compare import compare_evaluations
from diner_tpu_torch.image_ops import masked_downsample
from diner_tpu_torch.image_ops.png import read_png
from diner_tpu_torch.models import from_jax
from diner_tpu_torch.models.lightning import from_lightning
from diner_tpu_torch.train import ckpt_io
from diner_tpu_torch.utils import visualize

sys.path.insert(0, str(Path(__file__).parent))
from test_model_port import _fake_lightning_sd  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


# -- masked_downsample -----------------------------------------------------

def _image_and_mask(partial: bool):
    rng = np.random.RandomState(7 + partial)
    x = rng.rand(2, 16, 24, 3).astype(np.float32)
    m = (rng.rand(2, 16, 24, 1) > 0.4).astype(np.float32)
    m[:, :4, :8] = 0                     # whole background cells
    m[:, 8:, 16:] = 1                    # whole foreground cells
    if partial:
        m = np.where(m > 0, rng.choice([0.5, 1.0], m.shape), 0).astype(
            np.float32)
    return x, m


@pytest.mark.parametrize("mode,partial,bg", [
    ("average", False, 0.0), ("average", True, 0.0), ("average", True, 0.25),
    ("nearest", False, 0.0)])
def test_masked_downsample_matches_jax(mode, partial, bg):
    x, m = _image_and_mask(partial)
    for factor in (2, 4):
        want = np.asarray(j_masked_downsample(jnp.asarray(x), jnp.asarray(m),
                                              factor, mode=mode,
                                              bg_color=bg))
        got = masked_downsample(torch.from_numpy(x), torch.from_numpy(m),
                                factor, mode=mode, bg_color=bg)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        masked_downsample(torch.from_numpy(x), torch.from_numpy(m), 5)
    with pytest.raises(ValueError):
        masked_downsample(torch.from_numpy(x), torch.from_numpy(m), 2,
                          mode="cubic")


# -- compare and visualize -------------------------------------------------

def _report_dirs(tmp_path, n_pairs=6):
    """Two models' eval dirs: visualizations with -pred/-gt PNGs (model b's
    sample 2 prediction missing), a detailed report (model b's without
    lpips) and examples.png."""
    rng = np.random.RandomState(0)
    dirs = []
    for m in range(2):
        d = tmp_path / f"model{m}"
        (d / "vis").mkdir(parents=True)
        rows = []
        for i in range(n_pairs):
            for kind in ("pred", "gt"):
                Image.fromarray((rng.rand(16, 20, 3) * 255).astype(
                    np.uint8)).save(d / "vis" / f"s{i}-{kind}.png")
            # sample 2's PSNR spreads most between the models
            row = {"path": str(d / "vis" / f"s{i}-pred.png"),
                   "psnr": 20 + m + rng.rand() + 5 * m * (i == 2),
                   "l1": 0.05 - 0.01 * m + 0.001 * i}
            if m == 0:
                row["lpips"] = 0.2
            rows.append(row)
        if m == 1:                       # a prediction that went missing
            (d / "vis" / "s2-pred.png").unlink()
        (d / REPORT_DETAIL_FILENAME).write_text(json.dumps(rows))
        strip = (rng.rand(min(N_EXAMPLE_PLOTS, n_pairs) * 12, 60, 3)
                 * 255).astype(np.uint8)
        Image.fromarray(strip).save(d / EXAMPLE_PLOT_FILENAME)
        dirs.append(d)
    return dirs


def _same_outputs(a: Path, b: Path):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for n in names:
        if n.endswith(".png"):
            np.testing.assert_array_equal(read_png(a / n), read_png(b / n), n)
        else:
            assert (a / n).read_bytes() == (b / n).read_bytes(), n
    return names


@pytest.mark.parametrize("n_pairs", [6, 3])
def test_compare_evaluations_matches_jax(tmp_path, capsys, n_pairs):
    """The same plots as JAX's: the metrics common to both reports (no
    lpips), min(N_EXAMPLE_PLOTS, pairs) example sheets, the difference
    plots with the missing prediction skipped and reported."""
    dirs = _report_dirs(tmp_path, n_pairs)
    j_compare(dirs, ["a", "b"], tmp_path / "jax", n_examples=1)
    want_msgs = capsys.readouterr().out
    compare_evaluations(dirs, ["a", "b"], tmp_path / "port", n_examples=1)
    assert capsys.readouterr().out == want_msgs
    assert "missing prediction" in want_msgs
    names = _same_outputs(tmp_path / "port", tmp_path / "jax")
    assert "metric_violins.png" in names
    assert sum(n.startswith("examples_") for n in names) == min(
        N_EXAMPLE_PLOTS, n_pairs)
    assert not any("lpips" in n for n in names)
    assert {"diff_psnr_0.png", "diff_l1_0.png"} <= set(names)


def test_eval_folder_compare_subcommand(tmp_path):
    dirs = _report_dirs(tmp_path)
    assert eval_folder.main(["compare", str(tmp_path / "cli"),
                             f"a={dirs[0]}", f"b={dirs[1]}",
                             "--n-examples", "1"]) == 0
    compare_evaluations(dirs, ["a", "b"], tmp_path / "fn", n_examples=1)
    _same_outputs(tmp_path / "cli", tmp_path / "fn")
    with pytest.raises(SystemExit):
        eval_folder.main(["compare", str(tmp_path / "x"), str(dirs[0])])


def test_visualize_helpers_match_jax(tmp_path):
    s = SyntheticSphereDataset(n_scenes=1, n_views=3, H=16, W=20)[0]
    for pkg, name in ((j_vis, "jax"), (visualize, "port")):
        out = tmp_path / name
        out.mkdir()
        assert pkg.save_sample_grid(s, out / "grid.png") == out / "grid.png"
        pkg.save_camera_rig(s["src_extrinsics"], out / "rig.png",
                            labels=["a", "b", "c"])
        depth = s["src_depths"][0][..., 0]
        pkg.reproject_depth_to_csv(depth, s["src_intrinsics"][0],
                                   s["src_extrinsics"][0], out / "pc.csv",
                                   stride=2)
    _same_outputs(tmp_path / "port", tmp_path / "jax")
    pts = np.loadtxt(tmp_path / "port" / "pc.csv", delimiter=",", skiprows=1)
    assert pts.shape[1] == 3 and len(pts) > 0


# -- cluster ---------------------------------------------------------------

def _fields(tmp_path):
    items = tmp_path / "items.txt"
    items.write_text("s1\ns2\n")
    return [
        dict(name="single", command=["python", "-m", "x", "--a", "1"],
             cpus=4, memory_mb=1000, disk_gb=5,
             accelerator="gpu:8:NVIDIA H100 80GB HBM3"),
        dict(name="arr", command=["python", "p.py", "--in", "d/{item}"],
             accelerator="gpu:1", array_file=str(items), concurrency=3,
             env={"A": "1", "B": "two"}),
        dict(name="cpu", command=["run"], log_dir="L", max_retries=0),
    ]


def test_to_condor_text_is_jaxs(tmp_path):
    for fields in _fields(tmp_path):
        assert to_condor(JobSpec(**fields)) == j_to_condor(JJobSpec(**fields))


def test_to_jobset_targets_gpu_nodes():
    mh = to_jobset(SPECS["diner-train-dtu-multihost"])
    yaml.safe_dump(mh)
    job = mh["spec"]["replicatedJobs"][0]["template"]["spec"]
    assert job["completions"] == job["parallelism"] == 4
    pod = job["template"]["spec"]
    assert pod["nodeSelector"] == {
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"}
    cont = pod["containers"][0]
    assert cont["resources"]["limits"]["nvidia.com/gpu"] == "8"
    assert not any(k.startswith("google.com") for k in
                   cont["resources"]["limits"])
    env = {e["name"]: e for e in cont["env"]}
    assert set(env) == {"MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"}
    assert env["MASTER_ADDR"]["value"] == (
        "diner-train-dtu-multihost-work-0-0.diner-train-dtu-multihost")
    assert env["WORLD_SIZE"]["value"] == "4"
    assert "job-completion-index" in \
        env["RANK"]["valueFrom"]["fieldRef"]["fieldPath"]
    cmd = cont["command"]
    assert cmd[:5] == ["python", "-m", "torch.distributed.run",
                       "--nproc-per-node", "8"]
    for flag, var in (("--nnodes", "WORLD_SIZE"), ("--node-rank", "RANK"),
                      ("--master-addr", "MASTER_ADDR"),
                      ("--master-port", "MASTER_PORT")):
        assert cmd[cmd.index(flag) + 1] == f"$({var})"

    arr = to_jobset(SPECS["facescape-preprocess"])
    job = arr["spec"]["replicatedJobs"][0]["template"]["spec"]
    n_subjects = len([ln for ln in (REPO / "assets/data_splits/facescape/"
                                    "subjects.txt").read_text().splitlines()
                      if ln.strip()])
    assert job["completions"] == n_subjects and job["parallelism"] == 10
    cont = job["template"]["spec"]["containers"][0]
    assert cont["resources"]["limits"]["nvidia.com/gpu"] == "1"
    assert cont["env"] == []
    assert "JOB_COMPLETION_INDEX" in cont["command"][2]
    assert "${ITEM}" in cont["command"][2]

    cpu = to_jobset(JobSpec(name="c", command=["run"]))
    pod = cpu["spec"]["replicatedJobs"][0]["template"]["spec"]["template"]
    assert pod["spec"]["nodeSelector"] == {}
    assert "nvidia.com/gpu" not in \
        pod["spec"]["containers"][0]["resources"]["limits"]
    assert gpu_request("gpu:2") == (2, None)
    with pytest.raises(ValueError):
        to_jobset(JobSpec(name="t", command=["x"],
                          accelerator="tpu-v5-lite-podslice:2x4"))


def test_run_local_concurrency_and_retries(tmp_path):
    items = tmp_path / "items.txt"
    items.write_text("a\nb\nc\nd\nb\n")
    spec = JobSpec(name="echo", command=["echo", "item={item}"],
                   array_file=str(items), concurrency=2, max_retries=1,
                   log_dir=str(tmp_path / "logs"))
    assert run_local(spec) == {"a": 0, "b": 0, "c": 0, "d": 0}
    assert "item=a" in (tmp_path / "logs" / "echo_a.log").read_text()

    lock, live, peak, calls = threading.Lock(), [0], [0], []

    def runner(argv, **kw):
        with lock:
            calls.append(argv)
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        time.sleep(0.05)
        with lock:
            live[0] -= 1
        rc = 3 if argv[-1] == "x" else 0
        return subprocess.CompletedProcess(argv, returncode=rc)

    spec = JobSpec(name="f", command=["run", "{item}"], concurrency=2,
                   max_retries=2, log_dir=str(tmp_path / "logs"))
    got = run_local(spec, items=["x", "y", "z", "w", "y"], runner=runner)
    assert got == {"x": 3, "y": 0, "z": 0, "w": 0}
    assert sum(c[-1] == "x" for c in calls) == 3      # 1 + 2 retries
    assert sum(c[-1] == "y" for c in calls) == 1      # de-duplicated
    assert peak[0] == 2


def test_submit_renders_every_spec(tmp_path, capsys):
    assert len(SPECS) == 7
    for name, spec in SPECS.items():
        assert any(a.startswith("diner_tpu_torch.") for a in spec.command)
        assert gpu_request(spec.accelerator)[1] == "NVIDIA H100 80GB HBM3"
        for backend, suffix in (("condor", ".sub"), ("jobset", ".yaml")):
            assert submit.main([name, "--backend", backend, "--data", "/d",
                                "--out", "/o", "--dir",
                                str(tmp_path / backend)]) == 0
            text = (tmp_path / backend / f"{name}{suffix}").read_text()
            assert "{data}" not in text and "{out}" not in text
            assert "/d/" in text or "/o/" in text
        capsys.readouterr()
        assert submit.main([name, "--backend", "local"]) == 0
        assert json.loads(capsys.readouterr().out)["name"] == name
    text = (tmp_path / "condor" / "facescape-preprocess.sub").read_text()
    assert "request_gpus = 1" in text
    assert "queue Item from assets/data_splits/facescape/subjects.txt" in text
    manifest = yaml.safe_load(
        (tmp_path / "jobset" / "mvs-train-dtu.yaml").read_text())
    assert manifest["metadata"]["name"] == "mvs-train-dtu"
    assert submit.main(["mvs-write-facescape", "--backend", "condor"]) == 0
    assert "diner_tpu_torch.cli.mvs write" in capsys.readouterr().out


# -- export_torch ----------------------------------------------------------

def _export_config(tmp_path, norm="batch"):
    conf = {"nerf": {"kwargs": {
        "sigma_activation": "relu",
        "encoder_conf": {"kwargs": {"backbone": "resnet34", "num_layers": 4,
                                    "norm": norm}},
        "poscode_conf": {"kwargs": {"num_freqs": 6, "freq_factor": 6.28}},
        "mlp_fine_conf": {"kwargs": {"n_blocks": 2, "d_hidden": 32,
                                     "combine_layer": 1}}}}}
    path = tmp_path / f"export_{norm}.yaml"
    path.write_text(yaml.safe_dump(conf))
    return path


def test_export_torch_diner_matches_jax_and_round_trips(tmp_path, capsys):
    """A port checkpoint made from JAX variables (through from_jax) exports
    to JAX's export_diner of the same variables, and loads back through
    from_lightning to the checkpoint's own tensors. A GroupNorm trunk is
    refused."""
    fake = _fake_lightning_sd(d_hidden=32, n_blocks=2, combine_layer=1)
    variables, _ = port_diner_checkpoint(fake, n_blocks=2, combine_layer=1)
    nerf_sd = from_jax(variables["params"], variables["batch_stats"])
    ckpt_io.save(tmp_path / "ckpts", 3, {"nerf": {}, "step": 3})
    ckpt_io.save(tmp_path / "ckpts", 7, {"nerf": nerf_sd, "step": 7})
    out = tmp_path / "diner.ckpt"
    export_torch.main(["diner", "--ckpt", str(tmp_path / "ckpts"),
                       "--config", str(_export_config(tmp_path)),
                       "--znear", "0.321", "--zfar", "1.204",
                       "--out", str(out), "--hparams", '{"lr": 0.0001}'])
    assert "from step 7" in capsys.readouterr().out
    got = torch.load(out, weights_only=False)
    assert got["global_step"] == 7 and got["epoch"] == 0
    assert got["hyper_parameters"] == {"lr": 0.0001}
    want = export_diner(variables, znear=0.321, zfar=1.204)
    sd = got["state_dict"]
    assert sd.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), k)
        assert sd[k].numpy().dtype == np.asarray(v).dtype, k
    back, extras = from_lightning(sd)
    assert back.keys() == nerf_sd.keys()
    for k, v in nerf_sd.items():
        assert torch.equal(back[k], v), k
    assert extras["znear"] == np.float32(0.321)

    group = _export_config(tmp_path, "group")
    ckpt_io.save(tmp_path / "group", 1, {"step": 1, "nerf": build_nerf(
        load_config(group)["nerf"]).state_dict()})
    with pytest.raises(ValueError, match="BatchNorm"):
        export_torch.main(["diner", "--ckpt", str(tmp_path / "group"),
                           "--config", str(group),
                           "--znear", "1", "--zfar", "2",
                           "--out", str(tmp_path / "g.ckpt")])
    with pytest.raises(SystemExit, match="no checkpoint"):
        export_torch.main(["diner", "--ckpt", str(tmp_path / "none"),
                           "--config", str(_export_config(tmp_path)),
                           "--znear", "1", "--zfar", "2",
                           "--out", str(tmp_path / "n.ckpt")])
