"""diner_tpu_torch's data-parallel training against diner_tpu's on the CPU.

Two ranks are two child processes joined over gloo (`init_multihost` with
device "cpu"), each on one intra-op thread. The JAX reference is the JAX
package's train step on the global batch of 2 (`make_train_step`), on
test_torch_train.py's tiny DINER (2-layer encoder, ResnetFC 32 x 3 blocks,
32x32 images, one 8x8 patch a scene, VGG 0.1 and antibias 1.0), with group
and with batch norm; its draws (the patch pixels and the sampler noise) are
rebuilt from its key splits, and each rank gets its row of them. After one
step, on both ranks:
- the logged losses are JAX's global-batch losses within 1e-5 rel + 1e-6
  abs (the ranks' means averaged: sums in another order);
- every parameter is within test_torch_train.py's one-step tolerance of
  optax's (1e-5 abs; 2 lr + 1e-6 where the global gradient is within
  1e-4 of its largest entry of 0, where Adam's first step may move either
  way), the BatchNorm running statistics within 1e-5 of flax's on the
  global batch;
- the two ranks hold the same parameters bitwise.
Each rank's gradient after the all-reduce is jax.grad on the global batch
(test_torch_train.py's gradient tolerance).
Also here: the collective NaN guard, rank 0 alone writing the run and both
ranks resuming from it, every rank waiting for rank 0's last validation,
cli/train --multihost from torchrun's variables (and raising without them),
the per-rank draws, the loader's per-process order, process_local_slice,
init_multihost without a group, and the TensorBoard events. The children
run while the parent builds the JAX reference; each has 120 s.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import test_torch_train as tt
from diner_tpu.data import SyntheticSphereDataset as JDataset
from diner_tpu.data.loader import BatchLoader as JBatchLoader
from diner_tpu.parallel import process_local_slice as j_process_local_slice
from diner_tpu.train.state import TrainState as JTrainState
from diner_tpu.train.state import make_optimizer
from diner_tpu.train.step import make_train_step
from diner_tpu_torch.data import BatchLoader
from diner_tpu_torch.models import from_jax
from diner_tpu_torch.parallel import init_multihost, mesh
from diner_tpu_torch.train import MetricLogger
from diner_tpu_torch.train.loop import step_generator

REPO = Path(__file__).resolve().parents[1]
NORMS = ("group", "batch")
CHILD_TIMEOUT = 120

CHILD = r"""
import itertools
import sys
import time
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)
tmp, coordinator, r = Path(sys.argv[1]), sys.argv[2], int(sys.argv[3])
out = {"pid": __import__("os").getpid()}

# cli/train --multihost from torchrun's variables (set by the parent); it
# joins the group and leaves it at the end
from diner_tpu_torch.cli import train as train_cli

state = train_cli.main([str(tmp / "cli.yaml"), "--logdir", str(tmp / "logs"),
                        "--multihost", "--device", "cpu", "--log-every", "1"])
out["cli"] = {k: v.clone() for k, v in state.model.nerf.state_dict().items()}
assert not torch.distributed.is_initialized()

from diner_tpu_torch.core import RenderConfig
from diner_tpu_torch.models import DINER, PixelNeRF
from diner_tpu_torch.parallel import init_multihost, is_main, mesh, rank
from diner_tpu_torch.train import create_train_state, train, train_step

dev = init_multihost(coordinator, 2, r, device="cpu")
assert (str(dev), rank(), mesh.world_size(), is_main()) == ("cpu", r, 2,
                                                            r == 0)
# the parent writes the JAX model's weights and draws while the CLI runs
while not (tmp / "inputs.pt").exists():
    time.sleep(0.1)
inp = torch.load(tmp / "inputs.pt", weights_only=False)
cfg = inp["config"]
rows = slice(r, r + 1)


def diner(norm):
    return DINER(PixelNeRF(encoder_norm=norm, **cfg["nerf"]),
                 RenderConfig(**cfg["render"]), znear=cfg["znear"],
                 zfar=cfg["zfar"], **cfg["loss"])


def rank_rows(case):
    return ({k: v[rows] for k, v in case["batch"].items()},
            case["pix"][rows], tuple(n[rows] for n in case["noise"]))


for norm in ("group", "batch"):
    case = inp[norm]
    model = diner(norm)
    model.load_state_dict(case["sd"])
    state = create_train_state(model, cfg["lr"])
    batch, pix, noise = rank_rows(case)
    losses = train_step(state, batch, pix=pix, noise=noise)
    out[norm] = {"losses": losses, "sd": model.state_dict(),
                 "grads": {n: p.grad.clone()
                           for n, p in model.named_parameters()
                           if p.grad is not None}}

# the collective NaN guard: a batch that is not finite on rank 1 only
model = diner("batch")
model.load_state_dict(inp["batch"]["sd"])
state = create_train_state(model, cfg["lr"])
batch, pix, noise = rank_rows(inp["batch"])
first = train_step(state, batch, pix=pix, noise=noise)
before = {k: v.clone() for k, v in model.state_dict().items()}
opt = {i: {n: t.clone() for n, t in s.items()}
       for i, s in state.optimizer.state_dict()["state"].items()}
bad = dict(batch, src_rgbs=batch["src_rgbs"].clone())
if r == 1:
    bad["src_rgbs"][0, 0, 0, 0, 0] = float("nan")
second = train_step(state, bad, pix=pix, noise=noise)
out["nan"] = {
    "first": first, "second": second, "step": state.step,
    "last_epoch": state.scheduler.last_epoch,
    "model_kept": all(torch.equal(v, before[k])
                      for k, v in model.state_dict().items()),
    "adam_kept": all(torch.equal(t, opt[i][n]) for i, s in
                     state.optimizer.state_dict()["state"].items()
                     for n, t in s.items()),
    "has_running_var": any(k.endswith("running_var") for k in before)}


# the loop: rank 0 alone logs and saves; a resume on both ranks
class Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        torch.manual_seed(r)        # unlike on the other rank: broadcast
        self.nerf = torch.nn.Linear(4, 4)

    def losses(self, batch, train=True, pix=None, noise=None,
               generator=None):
        return {"total": ((self.nerf(batch["x"]) - batch["y"]) ** 2).mean()}


rs = np.random.RandomState(10 + r)
batches = itertools.repeat({"x": rs.randn(2, 4).astype(np.float32),
                            "y": rs.randn(2, 4).astype(np.float32)})


def run(d, steps, **kw):
    return train(Toy(), batches, tmp / d, max_steps=steps, log_every=1,
                 device="cpu", lr=1e-2, **kw).model.nerf.state_dict()


out["straight"] = run("c", 4, ckpt_every=0)
run("b", 4, ckpt_every=2)
if r == 0:
    (tmp / "b" / "ckpts" / "step_00000004.pt").unlink()
mesh.barrier(dev)
out["resumed"] = run("b", 4, ckpt_every=0, resume=True)


# rank 0's last validation is slow: rank 1 leaves train() only after it
def slow_val(state, step):
    if step == 2:
        time.sleep(1.0)
        out["val_done"] = time.time()


run("v", 2, ckpt_every=0, val_every=1, val_fn=slow_val)
out["left"] = time.time()
torch.save(out, tmp / f"out_{r}.pt")
torch.distributed.destroy_process_group()
print(f"rank {r}: OK")
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_inputs():
    """For each norm, JAX's tiny DINER and its variables; the global batch
    and JAX's draws for it; and what the children get (the port's
    state_dicts, the batch and the draws as tensors)."""
    batch = tt._batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(3)
    k_pix, k_render = jax.random.split(key)
    refs = {}
    for norm in NORMS:
        jm = tt._jdiner(norm)
        variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jbatch,
                                     jax.random.PRNGKey(1))
        params = tt._perturb(variables["params"], np.random.RandomState(5))
        stats = variables.get("batch_stats")
        refs[norm] = dict(jm=jm, jbatch=jbatch, key=key, params=params,
                          stats=stats,
                          sd=from_jax({"params": params, **(
                              {"batch_stats": stats} if stats else {})}))
    # the patch pixels depend on the batch's masks and the key alone
    pix = jax.jit(lambda k, b: refs["group"]["jm"].apply(
        {"params": refs["group"]["params"]}, k, b, tt.SB, tt.H, tt.W,
        method="_select_pixels"))(k_pix, jbatch)
    child = {"batch": {k: tt._t(v) for k, v in batch.items()},
             "pix": tt._t(pix),
             "noise": tt._jax_draws(k_render, tt.SPATCH * tt.SPATCH)}
    return refs, {norm: dict(child, sd=refs[norm]["sd"]) for norm in NORMS}


def _jax_step(ref):
    def loss_fn(p):
        v = {"params": p}
        if ref["stats"] is not None:
            v["batch_stats"] = ref["stats"]
            out, _ = ref["jm"].apply(v, ref["jbatch"], ref["key"], train=True,
                                     method="losses", mutable=["batch_stats"])
        else:
            out = ref["jm"].apply(v, ref["jbatch"], ref["key"], train=True,
                                  method="losses")
        return out["total"]

    grads = jax.jit(jax.grad(loss_fn))(ref["params"])
    tx = make_optimizer(ref["params"], tt.LR)
    state = JTrainState(step=0, params=ref["params"],
                        batch_stats=ref["stats"],
                        opt_state=tx.init(ref["params"]), tx=tx)
    new_state, losses = make_train_step(ref["jm"])(
        jax.tree.map(jnp.array, state), ref["jbatch"], ref["key"])
    extra = ({"batch_stats": new_state.batch_stats} if ref["stats"]
             else {})
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": from_jax(grads),
            "sd": from_jax({"params": new_state.params, **extra})}


def _cli_config(tmp: Path) -> Path:
    conf = yaml.safe_load((REPO / "configs" / "train_synthetic.yaml")
                          .read_text())
    conf["trainer"]["kwargs"]["max_steps"] = 2
    conf["optimizer"]["kwargs"]["n_samples_score_eval"] = 1
    del conf["optimizer"]["kwargs"]["cam_sweep_settings"]
    path = tmp / "cli.yaml"
    path.write_text(yaml.safe_dump(conf))
    return path


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Starts the two ranks (which run the CLI first, then wait for the JAX
    model's weights and draws), builds the JAX reference while they run,
    and returns both (and the children's directory)."""
    tmp = tmp_path_factory.mktemp("ranks")
    _cli_config(tmp)
    script = tmp / "child.py"
    script.write_text(CHILD)
    coordinator = f"127.0.0.1:{_free_port()}"
    cli_port = str(_free_port())
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=cli_port,
                   WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(tmp), coordinator, str(r)],
            env=env, cwd=str(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        refs, child = _jax_inputs()
        torch.save({"config": dict(nerf=tt.NERF_KW, render=tt.RENDER_KW,
                                   loss=tt.LOSS_KW, znear=JDataset.znear,
                                   zfar=JDataset.zfar, lr=tt.LR), **child},
                   tmp / "inputs.tmp")
        (tmp / "inputs.tmp").rename(tmp / "inputs.pt")
        steps = {norm: _jax_step(refs[norm]) for norm in NORMS}
        logs = [p.communicate(timeout=CHILD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"rank {r}: OK" in log, log[-3000:]
    outs = [torch.load(tmp / f"out_{r}.pt", weights_only=False)
            for r in range(2)]
    return dict(jax=steps, outs=outs, tmp=tmp)


@pytest.mark.parametrize("norm", NORMS)
def test_two_rank_step_matches_jax_global_batch(ranks, norm):
    ref = ranks["jax"][norm]
    a, b = (o[norm] for o in ranks["outs"])
    for k, v in ref["losses"].items():
        if k != "skipped_nonfinite":
            assert abs(a["losses"][k] - v) <= 1e-5 * abs(v) + 1e-6, k
    assert a["losses"] == b["losses"] and a["losses"]["skipped_nonfinite"] \
        == ref["losses"]["skipped_nonfinite"] == 0.0
    n_stats = 0
    for name, want in ref["sd"].items():
        if not name.startswith("nerf.") or name.endswith("tracked"):
            continue
        got = a["sd"][name]
        assert torch.equal(got, b["sd"][name]), name
        if name.endswith(("running_mean", "running_var")):
            n_stats += 1
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                       err_msg=name)
            continue
        g = a["grads"][name].abs()
        tol = torch.where(g > 1e-4 * g.max(), 1e-5, 2 * tt.LR + 1e-6)
        err = (got - want).abs()
        assert bool((err <= tol).all()), (name, float(err.max()))
    assert n_stats == (2 * 7 if norm == "batch" else 0)


@pytest.mark.parametrize("norm", NORMS)
def test_two_rank_gradient_is_the_global_batch_mean(ranks, norm):
    """Each rank's gradient after the all-reduce is jax.grad of the total
    on the global batch, within test_torch_train.py's gradient tolerance
    (1e-4 rel + 1e-4 of the largest entry): the ranks' mean, not their
    sum, which would be twice it."""
    ref = ranks["jax"][norm]["grads"]
    a, b = (o[norm]["grads"] for o in ranks["outs"])
    names = [n for n in ref if n.startswith("nerf.")]
    assert names and set(names) <= set(a)
    for name in names:
        want = ref[name]
        scale = float(want.abs().max())
        assert scale > 0, name
        assert torch.equal(a[name], b[name]), name
        err = (a[name] - want).abs()
        assert bool((err <= 1e-4 * want.abs() + 1e-4 * scale).all()), \
            (name, float(err.max()), scale)


def test_collective_nan_guard_skips_on_every_rank(ranks):
    """Rank 1's batch holds a NaN, rank 0's does not: both ranks log the
    global total (not finite) and skip; parameters, Adam's state, the
    schedule and the BatchNorm buffers stay as the first step left them."""
    for r, o in enumerate(ranks["outs"]):
        nan = o["nan"]
        assert nan["first"]["skipped_nonfinite"] == 0.0, r
        assert nan["second"]["skipped_nonfinite"] == 1.0, r
        assert not np.isfinite(nan["second"]["total"]), r
        assert nan["step"] == 1 and nan["last_epoch"] == 1, r
        assert nan["model_kept"] and nan["adam_kept"], r
        assert nan["has_running_var"]


def test_rank0_alone_writes_and_both_ranks_resume_alike(ranks):
    """Rank 0 alone writes metrics.jsonl, tb/ and the checkpoints; the
    ranks start from different weights (the broadcast makes them rank
    0's), and a resume from the step-2 checkpoint gives both ranks the
    straight run's parameters bitwise."""
    tmp, (o0, o1) = ranks["tmp"], ranks["outs"]
    run = tmp / "b"
    steps = [json.loads(x)["step"] for x in
             (run / "metrics.jsonl").read_text().splitlines()]
    assert steps == [0, 1, 2, 3, 2, 3]
    assert sorted(p.name for p in (run / "ckpts").iterdir()) == [
        "step_00000002.pt", "step_00000004.pt"]
    events = list((run / "tb").iterdir())
    assert len(events) == 2 and all(f".{o0['pid']}." in p.name
                                    for p in events)
    for k, v in o0["straight"].items():
        for o in (o0, o1):
            assert torch.equal(o["straight"][k], v), k
            assert torch.equal(o["resumed"][k], v), k


def test_ranks_leave_train_after_rank0_validation(ranks):
    """The barrier at the end of train() holds every rank until rank 0's
    last validation (a one-second sleep here) is done."""
    o0, o1 = ranks["outs"]
    assert "val_done" not in o1
    assert o1["left"] >= o0["val_done"]


def test_cli_multihost_writes_one_run_dir(ranks):
    """cli/train --multihost --logdir from torchrun's variables: one time
    stamp (rank 0's) names the run directory of both ranks, with rank 0's
    config snapshot, revision, metrics and checkpoint; both ranks end with
    the same model."""
    runs = list((ranks["tmp"] / "logs").iterdir())
    assert len(runs) == 1, runs
    run = runs[0]
    assert {"config.yaml", "GIT_REVISION", "metrics.jsonl", "ckpts",
            "eval_000002"} <= {p.name for p in run.iterdir()}
    lines = [json.loads(x) for x in
             (run / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [0, 1, 2]
    assert "valscores_psnr" in lines[2]
    a, b = (o["cli"] for o in ranks["outs"])
    assert all(torch.equal(v, b[k]) for k, v in a.items())


def test_step_generator_per_rank_streams():
    """At world size 1 the generator draws what the single process always
    drew (seed * 1_000_003 + step); across ranks each (step, rank) has its
    own stream."""
    for seed, step in ((0, 0), (3, 17)):
        want = torch.Generator().manual_seed(seed * 1_000_003 + step)
        got = step_generator("cpu", seed, step)
        assert torch.equal(torch.rand(64, generator=got),
                           torch.rand(64, generator=want))
        same = step_generator("cpu", seed, step, rank=0, world=1)
        assert same.initial_seed() == want.initial_seed()
    draws = {(s, r): torch.rand(8, generator=step_generator("cpu", 1, s, r,
                                                            2))
             for s in range(3) for r in range(2)}
    assert len({tuple(d.tolist()) for d in draws.values()}) == len(draws)


@pytest.mark.parametrize("pc", [1, 2, 3])
@pytest.mark.parametrize("n", [0, 1, 5, 8])
def test_process_local_slice_matches_jax(n, pc):
    for pi in range(pc):
        for pad in (False, True):
            assert mesh.process_local_slice(n, pi, pc, pad) == \
                j_process_local_slice(n, pi, pc, pad), (pi, pad)


@pytest.mark.parametrize("pi", [0, 1])
def test_loader_order_per_process_matches_jax(monkeypatch, pi):
    """Process pi of 2 (padded slices, RandomState(seed + epoch) shuffles,
    drop_last): the port's batches are JAX's over two epochs."""
    monkeypatch.setattr(jax, "process_index", lambda: pi)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(mesh, "rank", lambda: pi)
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    ds = JDataset(n_scenes=9, n_views=2, H=8, W=8, seed=3)
    jl = JBatchLoader(ds, batch_size=2, shuffle=True, seed=1, num_threads=2)
    tl = BatchLoader(ds, batch_size=2, shuffle=True, seed=1, num_threads=2)
    assert tl.indices == jl.indices == j_process_local_slice(9, pi, 2, True)
    assert len(tl) == len(jl) == 2
    for _ in range(2):
        got, ref = list(tl), list(jl)
        assert len(got) == len(ref) == 2
        for a, b in zip(got, ref):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_init_multihost_without_a_group(monkeypatch):
    """No coordinator and one process: nothing is initialized and the
    device is returned; a coordinator without a rank raises; a coordinator
    nobody serves raises once the timeout has passed."""
    import datetime

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert init_multihost(device="cpu") == torch.device("cpu")
    assert init_multihost(num_processes=1, device="cpu") == \
        torch.device("cpu")
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="rank"):
        init_multihost("127.0.0.1:1", 2, device="cpu")
    with pytest.raises(Exception, match="(?i)timed? ?out|connect"):
        init_multihost(f"127.0.0.1:{_free_port()}", 2, 1, device="cpu",
                       timeout=datetime.timedelta(seconds=2))
    assert not torch.distributed.is_initialized()
    assert (mesh.rank(), mesh.world_size(), mesh.is_main()) == (0, 1, True)
    # cli/train --multihost asks for a group: finding none, it raises
    from diner_tpu_torch.cli import train as train_cli

    with pytest.raises(ValueError, match="no process group"):
        train_cli.main([str(REPO / "configs" / "train_synthetic.yaml"),
                        "--multihost", "--device", "cpu"])
    assert not torch.distributed.is_initialized()


def test_metric_logger_tensorboard_events_read_back(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    logger = MetricLogger(tmp_path)
    logger.log(0, {"total": 0.5, "rgb_fine": 0.25})
    logger.log(3, {"total": 0.125})
    logger.close()
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    assert set(acc.Tags()["scalars"]) == {"total", "rgb_fine"}
    assert [(e.step, e.value) for e in acc.Scalars("total")] == [
        (0, 0.5), (3, 0.125)]
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [0, 3]


def test_metric_logger_jsonl_only_without_tensorboard(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logger = MetricLogger(tmp_path)
    logger.log(1, {"total": 2.0})
    logger.close()
    assert not (tmp_path / "tb").exists()
    assert json.loads((tmp_path / "metrics.jsonl").read_text()) == {
        "step": 1, "total": 2.0}
