"""diner_tpu_torch's MVS training across ranks (`cli/mvs train --multihost`)
against one process at the global batch, on the CPU.

Two ranks are two child processes joined over gloo from torchrun's
variables, each on one intra-op thread, each running `cli/mvs train
--multihost --batch-size 1`; the reference is the same CLI in this process
at --batch-size 2, which draws the same global batch (rank r trains on row
r of it). Every run builds its cascade in float64 (test_torch_mvs_train's
reason: this cascade's float32 gradients stray by percents on the CPU; its
softmax stays float32, as JAX's does), on test_torch_mvs_train's 64x64 DTU
training tree, its GT depth maps given zero bands of other heights so
that the samples' masks differ, for two steps at --lr 5 (the warmup's lr
is 0 at the first update and 0.01 at the second), with --lrepochs putting
the first milestone (decay 10) at step 1 of the global batch: one step
later at each rank's batch. After the steps:
- each step's learning rate equal to the reference's, the second decayed;
- each step's logged loss and aux values (the global batch's: the
  depth smooth-L1s are masked means over its pixels) within 1e-7 rel of
  the reference's;
- every parameter after Adam within 1e-7 abs of the reference's, and the
  two ranks' bitwise equal;
- the synced BatchNorm running statistics, 2D and 3D, within 1e-7 abs;
- rank 0 alone wrote the checkpoints, into the shared --logdir.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from diner_tpu_torch.cli import mvs as mvs_cli
from diner_tpu_torch.data import codecs
from diner_tpu_torch.mvs.train import batch_indices
from diner_tpu_torch.train import ckpt_io

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_mvs_train import _write_dtu_train_tree  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT = 150
ARCH = ["--ndepths", "8,8,8", "--depth_inter_r", "4,2,1", "--cr_base_chs",
        "4,4,4", "--base_channels", "4", "--numdepth", "32"]

CHILD = r"""
import sys

import torch

torch.set_num_threads(1)
from diner_tpu_torch.cli import mvs

held = {}
real = mvs.build_net


def build_net(args, device):
    held["net"] = real(args, device).double()
    return held["net"]


mvs.build_net = build_net
recs = mvs.main(sys.argv[2:])
torch.save({"recs": recs, "sd": held["net"].state_dict(),
            "group_left": not torch.distributed.is_initialized()},
           sys.argv[1])
"""


def _argv(root, listfile, logdir, batch, lrepochs):
    return ["train", "--datapath", str(root), "--listfile", str(listfile),
            "--logdir", str(logdir), "--max-steps", "2", "--batch-size",
            str(batch), "--lr", "5", "--lrepochs", lrepochs, "--log-every",
            "1", "--device", "cpu", *ARCH]


def _vary_masks(root):
    """Zero bands of 4 to 31 rows atop the GT depth maps, by camera."""
    for i, path in enumerate(sorted((root / "Depths/scan1").glob("*.pfm"))):
        depth = codecs.read_pfm(path)[0].copy()
        depth[:4 + i % 28] = 0.0
        codecs.write_pfm(path, depth)


def _dataset(root, listfile):
    args = mvs_cli.parser().parse_args(_argv(root, listfile, "x", 1, "1:2"))
    return mvs_cli.build_mvs_dataset(args, "train")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mvs_ranks")
    root = tmp / "dtu"
    root.mkdir()
    listfile = _write_dtu_train_tree(root)
    _vary_masks(root)
    # the first milestone at 2.5 steps an epoch of the global batch of 2:
    # step 1 there, step 2 counted at one rank's batch
    lrepochs = f"{2.5 / len(_dataset(root, listfile))}:10"
    port = str(_free_port())
    procs = []
    for r in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   WORLD_SIZE="2", RANK=str(r), LOCAL_RANK="0",
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get(
                       "PYTHONPATH", "")]))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD, str(tmp / f"rank{r}.pt"),
             *_argv(root, listfile, tmp / "ranks", 1, lrepochs),
             "--multihost"],
            env=env, cwd=str(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))

    # the reference meanwhile: one process at the global batch
    held = {}
    real = mvs_cli.build_net

    def build_net(args, device):
        held["net"] = real(args, device).double()
        return held["net"]

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mvs_cli.build_net = build_net
        ref = mvs_cli.main(_argv(root, listfile, tmp / "one", 2, lrepochs))
    finally:
        mvs_cli.build_net = real
        torch.set_num_threads(n)
    outs = []
    for r, p in enumerate(procs):
        try:
            log, _ = p.communicate(timeout=CHILD_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"rank {r}:\n{log}"
        outs.append(torch.load(tmp / f"rank{r}.pt", weights_only=False))
    return {"ref": ref, "ref_sd": held["net"].state_dict(), "ranks": outs,
            "tmp": tmp, "dataset": _dataset(root, listfile)}


def test_two_ranks_log_the_global_batch_loss(runs):
    ref = runs["ref"]
    assert {"stage1_depth_l1", "stage3_entropy", "depth_loss"} <= set(ref[0])
    for out in runs["ranks"]:
        assert out["group_left"]
        assert [r["step"] for r in out["recs"]] == [0, 1]
        for got, want in zip(out["recs"], ref):
            assert set(got) == set(want) | {"allreduce_seconds"}
            for k in want:
                if k not in ("step", "seconds"):
                    np.testing.assert_allclose(got[k], want[k], rtol=1e-7,
                                               err_msg=k)
            assert got["allreduce_seconds"] >= 0
        assert all("allreduce_seconds" not in r for r in ref)


def test_lr_milestones_count_steps_of_the_global_batch(runs):
    """The reference's first milestone falls at step 1, and the ranks
    decay there too; their batches' masks differ, so a rank's masked mean
    is not the global one."""
    ref = runs["ref"]
    assert ref[0]["lr"] == 0.0
    np.testing.assert_allclose(ref[1]["lr"], 5.0 / 500 / 10, rtol=1e-12)
    for out in runs["ranks"]:
        assert [r["lr"] for r in out["recs"]] == [r["lr"] for r in ref]
    ds = runs["dataset"]
    for step in (0, 1):
        rows = batch_indices(step, 2, len(ds), 0)
        counts = [int((ds[int(i)]["mask"]["stage1"] > 0.5).sum())
                  for i in rows]
        assert counts[0] != counts[1], counts


def test_two_ranks_step_as_one_process_at_twice_the_batch(runs):
    """Parameters after two Adam updates and the BatchNorm statistics
    (FeatureNet's per view, the 3D UNets', PixelwiseNet's) match the
    reference's; the ranks hold the same weights bitwise."""
    want = runs["ref_sd"]
    a, b = (out["sd"] for out in runs["ranks"])
    for k, v in want.items():
        assert torch.equal(a[k], b[k]), k
        if k.endswith("num_batches_tracked"):
            assert torch.equal(a[k], v), k
            continue
        np.testing.assert_allclose(a[k].numpy(), v.numpy(), atol=1e-7,
                                   err_msg=k)
    stats = [k for k in want if k.endswith("running_var")]
    assert any(k.startswith("cost_regularization") for k in stats)
    # the second update moved the weights
    assert not torch.equal(want["feature.conv0.0.conv.weight"],
                           _initial()["feature.conv0.0.conv.weight"])


def _initial():
    args = mvs_cli.parser().parse_args(
        ["write", "--datapath", "x", "--listfile", "y", "--device", "cpu",
         *ARCH])
    return mvs_cli.build_net(args, torch.device("cpu")).double().state_dict()


def test_rank0_alone_writes_the_checkpoints(runs):
    tmp = runs["tmp"]
    assert ckpt_io.all_steps(tmp / "ranks" / "ckpts") == [2]
    saved = ckpt_io.restore_latest(tmp / "ranks" / "ckpts")[0]["model"]
    for k, v in runs["ranks"][0]["sd"].items():
        assert torch.equal(saved[k], v), k
    assert sorted(p.name for p in (tmp / "ranks").iterdir()) == ["ckpts"]
