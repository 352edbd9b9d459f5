"""diner_tpu_torch's MVS training (mvs/losses, train-mode BatchNorm and
TransMVSNet, mvs/train, cli/mvs train and finetune, the BlendedMVS and TnT
readers) against diner_tpu on the CPU.

The cascade is tiny (cr_base_chs 4,4,4, base channels 4, ndepths 8,8,8 over
32 hypotheses, 2 views at 64x64) with JAX's variables drawn from numpy
(test_torch_mvs's `_random_variables`) and carried to the port by
`mvs/checkpoint.py:from_jax`. JAX's train step is `diner_tpu.cli.mvs`'s:
`net.apply(train=True, mutable=["batch_stats"])`, `mvs_loss`, Adam; it is
jitted once for the file and runs in float64 (`jax.enable_x64`). Torch
runs on one intra-op thread.

Tolerances:
- losses (mvs_loss, mvs_loss_focal) and every aux entry on given volumes
  with exact GT-bin and WTA ties: 1e-6 rel + 1e-7 abs;
- warmup_multistep: 1e-6 rel (JAX's float32 against Python floats);
- train-mode BatchNorm, 2D and 3D: outputs 1e-5 abs, running statistics
  after two calls 1e-6 abs (flax computes the variance as mean(x^2) -
  mean(x)^2, torch in two passes);
- one train step of the cascade, the GT pixels at a near-tie of two
  hypotheses of stages 2 and 3 masked out (`_mask_bin_near_ties`): the
  port's float32 loss (`cascade_loss`) 1e-5 rel; then the port's step in
  float64 (its softmax stays float32, as JAX's does): the loss 1e-6 rel,
  each parameter's gradient within 3e-4 of its largest entry plus 1e-4 rel
  plus 1e-6 abs (the DCN biases just before a BatchNorm have a gradient of
  0, which JAX's float64 step puts at up to 3e-7; measured when the test
  was written: at most 8.6e-5 of the largest entry; in float32 on one
  thread the port's own gradients stray up to 1.3% from its float64 ones,
  JAX's up to 5%, so float32 cannot be held to JAX at any useful
  tolerance), BatchNorm running statistics 1e-5 abs,
  and after one Adam step at lr 1e-3 the parameters 1e-5 abs, except that
  an entry whose gradient is within the gradient tolerance of 0 may move
  by up to 2 lr (Adam's first step moves by about lr times the gradient's
  sign);
- the readers: every array equal.
"""

import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from diner_tpu.cli.mvs import warmup_multistep as j_warmup_multistep
from diner_tpu.mvs import datasets as j_datasets
from diner_tpu.mvs.losses import mvs_loss as j_mvs_loss
from diner_tpu.mvs.losses import mvs_loss_focal as j_mvs_loss_focal
from diner_tpu.mvs.net import TransMVSNet as JTransMVSNet
from diner_tpu_torch.cli import mvs as mvs_cli
from diner_tpu_torch.data import codecs
from diner_tpu_torch.image_ops.png import write_png
from diner_tpu_torch.mvs import TransMVSNet, from_jax
from diner_tpu_torch.mvs import datasets
from diner_tpu_torch.mvs.losses import mvs_loss, mvs_loss_focal
from diner_tpu_torch.mvs.train import (adam_count, cascade_loss,
                                       gt_tensors, make_optimizer,
                                       to_tensors, warmup_multistep)
from diner_tpu_torch.nn.resnet import BatchNorm, BatchNorm3d
from diner_tpu_torch.train import ckpt_io

sys.path.insert(0, str(Path(__file__).parent))
from test_mvs_cli import _bld_fixture  # noqa: E402
from test_mvs_cli import _cams as _bld_cams  # noqa: E402
from test_torch_mvs import (_projs, _random_variables,  # noqa: E402
                            _write_eval_tree)

ARCH = dict(ndepths=(8, 8, 8), depth_intervals_ratio=(4, 2, 1),
            cr_base_chs=(4, 4, 4), base_channels=4)
CLI_ARCH = ["--ndepths", "8,8,8", "--depth_inter_r", "4,2,1",
            "--cr_base_chs", "4,4,4", "--base_channels", "4",
            "--device", "cpu"]
V, H, W, NUMDEPTH = 2, 64, 64, 32
LR = 1e-3
DLOSSW = (0.5, 1.0, 2.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# -- losses ----------------------------------------------------------------

def _loss_inputs(seed=0, B=2, D=8, h=6, w=7):
    """Per stage a softmaxed volume, hypotheses with exact ties for the GT
    (GT halfway between two hypotheses) and for the WTA (equal largest
    probabilities), and masks, one of them empty."""
    rng = np.random.RandomState(seed)
    outputs, gt, mask = {}, {}, {}
    for si, st in enumerate(("stage1", "stage2", "stage3")):
        logits = rng.randn(B, D, h, w).astype(np.float32) * 2
        logits[0, 2, 0, 0] = logits[0, 5, 0, 0] = 9.0         # WTA tie
        pv = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        dv = np.broadcast_to(np.arange(D, dtype=np.float32)[None, :, None,
                                                             None] * 0.5
                             + 1.0, (B, D, h, w)).copy()
        g = (rng.rand(B, h, w) * 3.5 + 1.0).astype(np.float32)
        g[0, 1, :3] = [1.25, 2.75, 3.0]                       # GT ties
        m = (rng.rand(B, h, w) > 0.3).astype(np.float32)
        if si == 1:
            m[1] = 0.0                                         # empty mask
        outputs[st] = {"prob_volume": pv, "depth_values": dv,
                       "depth": np.take_along_axis(
                           dv, pv.argmax(1)[:, None], 1)[:, 0]}
        gt[st], mask[st] = g, m
    return outputs, gt, mask


@pytest.mark.parametrize("focal", [False, True])
def test_mvs_losses_match_jax(focal):
    outputs, gt, mask = _loss_inputs()
    j_out = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
             for k, v in outputs.items()}
    t_out = {k: {kk: _t(vv) for kk, vv in v.items()}
             for k, v in outputs.items()}
    jg = {k: jnp.asarray(v) for k, v in gt.items()}
    jm = {k: jnp.asarray(v) for k, v in mask.items()}
    tg = {k: _t(v) for k, v in gt.items()}
    tm = {k: _t(v) for k, v in mask.items()}
    if focal:
        dint = np.array([0.5, 0.25], np.float32)[:, None, None]
        want = j_mvs_loss_focal(j_out, jg, jm, jnp.asarray(dint),
                                dlossw=DLOSSW)
        got = mvs_loss_focal(t_out, tg, tm, _t(dint), dlossw=DLOSSW)
    else:
        want = j_mvs_loss(j_out, jg, jm, dlossw=DLOSSW)
        got = mvs_loss(t_out, tg, tm, dlossw=DLOSSW)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6,
                               atol=1e-7)
    assert sorted(got[1]) == sorted(want[1])
    for k, v in want[1].items():
        np.testing.assert_allclose(float(got[1][k]), float(v), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


# -- the schedule, BatchNorm -----------------------------------------------

def test_warmup_multistep_matches_jax():
    milestones, gamma = (700, 900), 0.5
    want = j_warmup_multistep(LR, milestones=milestones, gamma=gamma)
    got = warmup_multistep(LR, milestones=milestones, gamma=gamma)
    steps = [0, 1, 2, 250, 499, 500, 501, 699, 700, 701, 899, 900, 5000]
    for s in steps:
        np.testing.assert_allclose(got(s), float(want(jnp.asarray(s))),
                                   rtol=1e-6, err_msg=str(s))
    assert got(0) == 0.0 and got(500) == LR and got(900) == LR / 4


@pytest.mark.parametrize("dims", [2, 3])
def test_train_mode_batchnorm_matches_flax(dims):
    """Two train-mode calls: the second call's output and the running
    statistics after both, against flax's BatchNorm (momentum 0.9)."""
    rng = np.random.RandomState(dims)
    C = 5
    shape = (3, 4, 6, C) if dims == 2 else (2, 3, 4, 6, C)
    xs = [(rng.randn(*shape) * 2 + 1).astype(np.float32) for _ in range(2)]
    fm = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = fm.init(jax.random.PRNGKey(0), xs[0])
    scale = (1 + 0.1 * rng.randn(C)).astype(np.float32)
    bias = (0.1 * rng.randn(C)).astype(np.float32)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = variables["batch_stats"]
    for x in xs:
        want, mut = fm.apply({"params": params, "batch_stats": stats}, x,
                             mutable=["batch_stats"])
        stats = mut["batch_stats"]
    bn = (BatchNorm if dims == 2 else BatchNorm3d)(C, eps=1e-5).train()
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
        for x in xs:
            got = bn(_t(x).movedim(-1, 1))
    np.testing.assert_allclose(got.movedim(1, -1).numpy(), np.asarray(want),
                               atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-6)
    assert int(bn.num_batches_tracked) == 2


# -- one train step of the cascade ----------------------------------------

def _train_batch(seed=0):
    """A collated batch of one sample: V views of noise, the GT a slanted
    plane inside the hypotheses with an unmasked band."""
    rng = np.random.RandomState(seed)
    imgs = rng.rand(1, V, H, W, 3).astype(np.float32)
    dv = np.linspace(1.0, 2.0, NUMDEPTH, dtype=np.float32)[None]
    plane = (1.2 + 0.6 * np.arange(W, dtype=np.float32) / W
             )[None, None].repeat(H, 1)
    depth, mask = {}, {}
    for st, s in (("stage1", 4), ("stage2", 2), ("stage3", 1)):
        depth[st] = np.ascontiguousarray(plane[:, ::s, ::s])
        m = np.ones_like(depth[st])
        m[:, : 4 // s] = 0.0
        mask[st] = m
    return {"imgs": imgs, "proj_matrices": _projs(V, H, W),
            "depth_values": dv, "depth": depth, "mask": mask}


def _mask_bin_near_ties(batch, depth_values, margin=1e-4):
    """Mask out, at stages 2 and 3, the pixels whose GT lies within margin
    of the midpoint between two hypotheses: those hypotheses come from the
    previous stage's depth, and a rounding there may pick the other GT
    bin. Stage 1's hypotheses are the inputs', so its exact ties stay."""
    for st in ("stage2", "stage3"):
        dist = np.sort(np.abs(depth_values[st] - batch["depth"][st][:, None]),
                       axis=1)
        batch["mask"][st] = np.where(dist[:, 1] - dist[:, 0] < margin, 0.0,
                                     batch["mask"][st]).astype(np.float32)


@pytest.fixture(scope="module")
def train_step_case():
    """JAX's step (cli/mvs.py's `_train_impl`) on random variables: the
    loss, the gradients, the BatchNorm statistics after the step and the
    parameters after one Adam update at LR. It runs twice, the second time
    with the GT bins' near-ties masked out (`_mask_bin_near_ties`)."""
    net = JTransMVSNet(**ARCH)
    batch = _train_batch()
    example = (batch["imgs"], batch["proj_matrices"], batch["depth_values"])
    variables = _random_variables(net, example, seed=3)
    tx = optax.adam(LR)

    def f64(tree):
        return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)

    @jax.jit
    def step(params, batch_stats, batch):
        def loss_fn(p):
            out, mut = net.apply(
                {"params": p, "batch_stats": batch_stats}, batch["imgs"],
                batch["proj_matrices"], batch["depth_values"], train=True,
                mutable=["batch_stats"])
            total, aux = j_mvs_loss(out, batch["depth"], batch["mask"],
                                    dlossw=DLOSSW)
            dvals = {k: v["depth_values"] for k, v in out.items()
                     if k.startswith("stage")}
            return total, (mut["batch_stats"], dvals)

        (total, (stats, dvals)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return (total, grads, stats, optax.apply_updates(params, updates),
                dvals)

    def run():
        with jax.enable_x64(True):
            return jax.device_get(step(f64(variables["params"]),
                                       f64(variables["batch_stats"]),
                                       f64(batch)))

    _mask_bin_near_ties(batch, run()[-1])
    total, grads, stats, new_params, _ = run()
    return dict(batch=batch, sd=from_jax(variables), loss=float(total),
                grads=from_jax({"params": grads, "batch_stats": stats}),
                new_sd=from_jax({"params": new_params, "batch_stats": stats}))


@pytest.fixture(scope="module")
def port_step(train_step_case):
    """The port's step from the same weights: the float32 loss through
    `cascade_loss`, then in float64 the train-mode forward, the loss, the
    backward and one Adam update at LR."""
    batch, sd = train_step_case["batch"], train_step_case["sd"]
    net = TransMVSNet(**ARCH).train()
    net.load_state_dict(sd)
    with torch.no_grad():
        loss32 = cascade_loss(net, batch, "cpu", DLOSSW)[0].item()
    net = TransMVSNet(**ARCH).train()
    net.load_state_dict(sd)
    net.double()
    imgs, projs, dvals, depth, mask = jax.tree.map(
        lambda x: x.double(),
        to_tensors(batch, "cpu") + gt_tensors(batch, "cpu"))
    total, _ = mvs_loss(net(imgs, projs, dvals), depth, mask, dlossw=DLOSSW)
    total.backward()
    grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    opt = make_optimizer(net, LR)
    opt.step()
    return dict(net=net, loss32=loss32, loss=total.item(), grads=grads,
                opt=opt)


def test_train_step_loss_and_gradients_match_jax(train_step_case, port_step):
    """The gradient of every parameter: PixelwiseNet's carries only stage
    1's loss, since the view weights reach stages 2 and 3 without
    gradient, as JAX stops it."""
    np.testing.assert_allclose(port_step["loss32"], train_step_case["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(port_step["loss"], train_step_case["loss"],
                               rtol=1e-6)
    want = train_step_case["grads"]
    assert sorted(port_step["grads"]) == sorted(
        k for k in want if not k.split(".")[-1].startswith("running_")
        and not k.endswith("num_batches_tracked"))
    for name, g in port_step["grads"].items():
        w = want[name].numpy()
        tol = 3e-4 * np.abs(w).max() + 1e-4 * np.abs(w) + 1e-6
        assert (np.abs(g.numpy() - w) <= tol).all(), name
    pw = [k for k in want if "pixel_wise_net" in k and k.endswith("weight")]
    assert pw and all(np.abs(want[k].numpy()).max() > 0 for k in pw)


def test_train_step_batch_stats_and_adam_match_jax(train_step_case,
                                                   port_step):
    """The running statistics after the per-view FeatureNet calls and the
    other BatchNorms' updates, and the parameters after one Adam step."""
    new_sd = train_step_case["new_sd"]
    got = port_step["net"].state_dict()
    n_stats = 0
    for name, w in new_sd.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                       atol=1e-5, err_msg=name)
            n_stats += 1
    assert n_stats > 20
    # FeatureNet's BatchNorms were updated once per view, the cost
    # regularizers' once per step
    assert int(got["feature.conv0.0.bn.num_batches_tracked"]) == V
    assert int(got["cost_regularization.0.conv0.bn.num_batches_tracked"]) == 1
    grads = train_step_case["grads"]
    for name, p in port_step["net"].named_parameters():
        want = new_sd[name].numpy()
        g = grads[name].numpy()
        near0 = np.abs(g) <= 3e-4 * np.abs(g).max() + 1e-6
        tol = np.where(near0, 2 * LR, 1e-5)
        assert (np.abs(p.detach().numpy() - want) <= tol).all(), name
    assert adam_count(port_step["opt"]) == 1


# -- the CLI ---------------------------------------------------------------

def _write_dtu_train_tree(root):
    """A DTU-layout tree for MVS training: every corner cam's 7 lights at
    64x64 (smaller than 512x640, so prepare_img passes them whole), cam
    files at depth_min 425 and interval 2.5 (425-510 over 32 hypotheses),
    and GT depth maps inside that range with a row band of zeros."""
    rng = np.random.RandomState(3)
    cams = sorted({v for t, s in datasets.corner_view_metas("train")
                   for v in [t] + s})
    for sub in ("Cameras/train", "Rectified/scan1_train", "Depths/scan1"):
        (root / sub).mkdir(parents=True)
    K = np.array([[10.0, 0, 8.0], [0, 10.0, 8.0], [0, 0, 1]])
    for i, cam in enumerate(cams):
        ext = np.eye(4)
        ext[0, 3], ext[1, 3] = 10.0 * (i % 6), 10.0 * (i // 6)
        codecs.write_mvsnet_cam(root / "Cameras/train" / f"{cam:08d}_cam.txt",
                                ext, K, 425.0, 2.5)
        for light in range(7):
            write_png(root / "Rectified/scan1_train" /
                      f"rect_{cam + 1:03d}_{light}_r5000.png",
                      rng.randint(0, 255, (64, 64, 3), dtype=np.uint8))
        d = (440.0 + rng.rand(64, 64) * 40).astype(np.float32)
        d[:4] = 0.0
        codecs.write_pfm(root / "Depths/scan1" / f"depth_map_{cam:04d}.pfm", d)
    (root / "train.txt").write_text("scan1\n")
    return root / "train.txt"


@pytest.fixture(scope="module")
def dtu_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("dtu_train")
    return root, _write_dtu_train_tree(root)


def _train_args(cmd, root, listfile, logdir, *extra):
    return [cmd, "--datapath", str(root), "--listfile", str(listfile),
            "--logdir", str(logdir), "--numdepth", "32", "--log-every", "1",
            *CLI_ARCH, *extra]


def test_cli_train_save_every_and_resume(dtu_tree, tmp_path):
    """train --save-every 1 to step 2, then --resume to step 3: the resumed
    run starts at step 2 from the saved weights and Adam state (count 2).
    The first update runs at lr 0: the weights after step 1 are the
    initial ones, while BatchNorm's statistics moved."""
    root, listfile = dtu_tree
    logdir = tmp_path / "run"
    recs = mvs_cli.main(_train_args("train", root, listfile, logdir,
                                    "--max-steps", "2", "--save-every", "1"))
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert ckpt_io.all_steps(logdir / "ckpts") == [1, 2]
    torch.manual_seed(0)
    init = TransMVSNet(**ARCH).state_dict()
    first = ckpt_io.restore_latest(logdir / "ckpts", 1)[0]
    for k, v in first["model"].items():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        assert torch.equal(v, init[k]), k
    assert not torch.equal(first["model"]["feature.conv0.0.bn.running_var"],
                           init["feature.conv0.0.bn.running_var"])
    second = ckpt_io.restore_latest(logdir / "ckpts")[0]
    assert second["step"] == 2
    assert [int(s["step"]) for s in second["optimizer"]["state"].values()
            ][:1] == [2]

    recs = mvs_cli.main(_train_args("train", root, listfile, logdir,
                                    "--max-steps", "3", "--resume"))
    assert [r["step"] for r in recs] == [2]
    third = ckpt_io.restore_latest(logdir / "ckpts")[0]
    assert third["step"] == 3
    assert {int(s["step"]) for s in third["optimizer"]["state"].values()} \
        == {3}
    # a run from scratch to step 3 takes the same path
    recs_full = mvs_cli.main(_train_args("train", root, listfile,
                                         tmp_path / "full", "--max-steps",
                                         "3"))
    np.testing.assert_allclose(recs[0]["loss"], recs_full[2]["loss"],
                               rtol=1e-5)


def test_cli_write_and_eval_read_the_trained_checkpoint(dtu_tree, tmp_path):
    """write --ckpt builds the net from the checkpoint's weights and
    BatchNorm statistics (not the random ones of --seed) and writes the
    priors; eval --ckpt runs from it too."""
    root, listfile = dtu_tree
    logdir = tmp_path / "run"
    mvs_cli.main(_train_args("train", root, listfile, logdir,
                             "--max-steps", "1"))
    ckpt = ckpt_io.restore_latest(logdir / "ckpts")[0]["model"]
    args = mvs_cli.parser().parse_args(
        ["write", "--datapath", str(root), "--listfile", str(listfile),
         "--numdepth", "32", "--ckpt", str(logdir / "ckpts"),
         "--seed", "5", *CLI_ARCH])
    net = mvs_cli.build_net(args, torch.device("cpu"))
    assert not net.training
    for k, v in net.state_dict().items():
        assert torch.equal(v, ckpt[k]), k
    tree = tmp_path / "dtu"
    shutil.copytree(root, tree)
    (tree / "val.txt").write_text("scan1\n")
    seconds = mvs_cli.main(["write", "--datapath", str(tree), "--listfile",
                            str(tree / "val.txt"), "--numdepth", "32",
                            "--ckpt", str(logdir / "ckpts"), *CLI_ARCH])
    assert len(seconds) == 4
    pngs = sorted((tree / "Depths/scan1").glob("*_TransMVSNet.png"))
    assert len(pngs) == 4
    with pytest.raises(FileNotFoundError):
        mvs_cli.main(["write", "--datapath", str(tree), "--listfile",
                      str(tree / "val.txt"), "--numdepth", "32",
                      "--ckpt", str(tmp_path / "none"), *CLI_ARCH])
    ev = _write_eval_tree(tmp_path / "eval")
    seconds = mvs_cli.main(["eval", "--datapath", str(ev), "--testlist",
                            "scan9", "--outdir", str(tmp_path / "out"),
                            "--num_view", "4", "--numdepth", "32",
                            "--img_ext", ".png", "--ckpt",
                            str(logdir / "ckpts"), *CLI_ARCH])
    assert len(seconds) == 4
    assert (tmp_path / "out" / "scan9" / "depth_est" / "00000000.pfm").exists()


def test_cli_finetune_defaults_to_blendedmvs(tmp_path):
    """finetune (no --dataset) reads the BlendedMVS layout and trains with
    the focal loss's metrics for 2 steps."""
    root, listfile = _bld_fixture(tmp_path)
    logdir = tmp_path / "ft"
    recs = mvs_cli.main(["finetune", "--datapath", str(root), "--listfile",
                         str(listfile), "--logdir", str(logdir),
                         "--numdepth", "16", "--max-steps", "2",
                         "--log-every", "1", *CLI_ARCH])
    assert [r["step"] for r in recs] == [0, 1]
    for r in recs:
        assert {"epe", "less1", "less3", "depth_loss"} <= set(r)
        assert all(np.isfinite(v) for v in r.values())
    assert ckpt_io.all_steps(logdir / "ckpts") == [2]


def test_train_needs_cuda_unless_asked(dtu_tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, listfile = dtu_tree
    args = _train_args("train", root, listfile, tmp_path / "r",
                       "--max-steps", "1")
    args.remove("--device")
    args.remove("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        mvs_cli.main(args)


# -- the readers -----------------------------------------------------------

def _assert_samples_equal(a, b, where=""):
    assert sorted(a) == sorted(b), where
    for k, v in a.items():
        if isinstance(v, dict):
            _assert_samples_equal(v, b[k], f"{where}{k}.")
        elif isinstance(v, np.ndarray):
            assert v.dtype == b[k].dtype, f"{where}{k}"
            np.testing.assert_array_equal(v, b[k], err_msg=f"{where}{k}")


def test_blendedmvs_dataset_matches_jax(tmp_path):
    """Every array of every sample equal; the port's dpath names the
    reference view's rendered depth map (JAX's is None)."""
    root, listfile = _bld_fixture(tmp_path)
    want = j_datasets.BlendedMVSDataset(root, listfile, ndepths=16)
    got = datasets.BlendedMVSDataset(root, listfile, ndepths=16)
    assert len(got) == len(want) == 4
    for i in range(len(got)):
        w, g = want[i], got[i]
        assert w.pop("dpath") is None
        assert g.pop("dpath") == str(root / "sceneA" / "rendered_depth_maps"
                                     / f"{i:08d}.pfm")
        _assert_samples_equal(g, w)
    assert got[0]["mask"]["stage3"].mean() == 1.0


def test_tnt_dataset_matches_jax(tmp_path):
    """Three views capped to the scene's size and snapped to multiples of
    32 (80x112 -> 64x64); the third (72x140 -> 64x96) is resized to the
    first one's resolution."""
    scan = tmp_path / "tnt" / "Family"
    (scan / "images").mkdir(parents=True)
    (scan / "cams_1").mkdir()
    rng = np.random.RandomState(2)
    exts, K = _bld_cams()
    from PIL import Image

    for v, (h, w) in enumerate(((80, 112), (80, 112), (72, 140))):
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            scan / "images" / f"{v:08d}.jpg")
        lines = ["extrinsic"]
        lines += [" ".join(f"{x:.6f}" for x in row) for row in exts[v]]
        lines += ["", "intrinsic"]
        lines += [" ".join(f"{x:.6f}" for x in row) for row in K[v]]
        lines += ["", "1.0 0.01 192 2.5"]       # min interval number max
        (scan / "cams_1" / f"{v:08d}_cam.txt").write_text(
            "\n".join(lines) + "\n")
    pair = ["3"]
    for v in range(3):
        srcs = [s for s in range(3) if s != v]
        pair += [str(v), f"{len(srcs)} " + " ".join(f"{s} 10.0"
                                                    for s in srcs)]
    (scan / "pair.txt").write_text("\n".join(pair) + "\n")
    kw = dict(nviews=3, ndepths=8, image_sizes={"Family": (96, 64)})
    want = j_datasets.TnTEvalDataset(tmp_path / "tnt", ["Family"], **kw)
    got = datasets.TnTEvalDataset(tmp_path / "tnt", ["Family"], **kw)
    assert len(got) == len(want) == 3
    for i in range(3):
        _assert_samples_equal(got[i], want[i])
    assert got[0]["imgs"].shape == (3, 64, 64, 3)
