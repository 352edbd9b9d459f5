"""diner_tpu_torch's training path against diner_tpu's on the CPU.

A tiny DINER (2-layer encoder, ResnetFC 32 x 3 blocks, 32x32 images, SB 2,
8 samples from 64 candidates, one 8x8 patch a sample with VGG 0.1 and
antibias 1.0) with group and with batch norm. The JAX model is initialized,
its parameters perturbed with numpy noise, and carried to the port with
`from_jax` (the VGG tower and the batch stats included); both packages get
the same numpy batch, and the port gets JAX's draws: the pixel indices of
its `_select_pixels` and the sampler noise of its key splits. Tolerances
(float32):
- losses 1e-5 rel + 1e-6 abs: sums in another order;
- parameter gradients 1e-4 rel + 1e-4 of the parameter's largest gradient
  entry: the long reductions of the backward pass (convolution weight
  gradients over the batch, BatchNorm's backward through the batch
  statistics) in another order; measured on the CPU when written, at most
  3.7e-5 of the largest entry (batch norm), 1.1e-5 (group norm);
- Adam against optax on the same gradients 1e-7 abs (lr 1e-3 steps);
- after one train step, parameters within 1e-5 abs of optax's (Adam's first
  step moves every parameter by about lr = 1e-3 times the gradient's sign,
  so a gradient within noise of 0 may move either way: those entries are
  held to 2 lr instead) and BatchNorm running statistics within 1e-5.
Also here: the NaN guard, the loader's order, checkpoint resume, the patch
selection, the VGG tower and losses, the Lightning VGG map, the train CLI
on the CPU and `render_eval --ckpt`.
"""

import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diner_tpu.core.types import RenderConfig as JRenderConfig
from diner_tpu.data import SyntheticSphereDataset as JDataset
from diner_tpu.data import collate as j_collate
from diner_tpu.data import to_device_batch
from diner_tpu.data.loader import BatchLoader as JBatchLoader
from diner_tpu.image_ops import avg_pool2d as j_avg_pool2d
from diner_tpu.losses import antibias_loss as j_antibias_loss
from diner_tpu.losses import vgg_perceptual_loss as j_vgg_loss
from diner_tpu.models import PixelNeRF as JPixelNeRF
from diner_tpu.models.diner import DINER as JDINER
from diner_tpu.models.torch_port import export_diner, port_diner_checkpoint
from diner_tpu.nn import Vgg19Features as JVgg
from diner_tpu.parallel import process_local_slice as j_process_local_slice
from diner_tpu.renderer.composite import composite_outputs as j_composite
from diner_tpu.train.state import TrainState as JTrainState
from diner_tpu.train.state import make_optimizer
from diner_tpu.train.step import make_train_step
from diner_tpu_torch.cli import render_eval
from diner_tpu_torch.cli import train as train_cli
from diner_tpu_torch.core import RenderConfig
from diner_tpu_torch.data import BatchLoader, process_local_slice
from diner_tpu_torch.image_ops import avg_pool2d
from diner_tpu_torch.kernels import composite_rays_backward_plain
from diner_tpu_torch.losses import antibias_loss, vgg_perceptual_loss
from diner_tpu_torch.models import (DINER, PixelNeRF, from_jax,
                                    from_lightning, to_lightning)
from diner_tpu_torch.models.diner import to_tensors
from diner_tpu_torch.nn import Vgg19Features
from diner_tpu_torch.nn.resnet import BatchNorm
from diner_tpu_torch.train import (create_train_state, eval_step, train,
                                   train_step)
from diner_tpu_torch.train import ckpt_io
from diner_tpu_torch.train.loop import restore_checkpoint
from diner_tpu_torch.train.state import lr_factor

from test_model_port import _fake_lightning_sd  # noqa: E402

SB, H, W, SPATCH = 2, 32, 32, 8
LR = 1e-3
NERF_KW = dict(encoder_layers=2, image_padding=4, padding_pe=2, n_blocks=3,
               d_hidden=32, combine_layer=2)
RENDER_KW = dict(n_samples=8, n_depth_candidates=64, n_gaussian=3)
LOSS_KW = dict(w_vgg=0.1, vgg_spatch=SPATCH, w_antibias=1.0,
               antibias_downsampling=2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(n=SB, seed=0):
    ds = JDataset(n_scenes=n, n_views=2, H=H, W=W, seed=seed)
    return to_device_batch(j_collate([ds[i] for i in range(n)]))


def _jdiner(norm):
    return JDINER(nerf=JPixelNeRF(encoder_norm=norm, **NERF_KW),
                  render_cfg=JRenderConfig(**RENDER_KW),
                  znear=JDataset.znear, zfar=JDataset.zfar, **LOSS_KW)


def _tdiner(norm, **kw):
    return DINER(PixelNeRF(encoder_norm=norm, **NERF_KW, **kw),
                 RenderConfig(**RENDER_KW), znear=JDataset.znear,
                 zfar=JDataset.zfar, **LOSS_KW)


def _perturb(tree, rng):
    return jax.tree.map(lambda v: v + jnp.asarray(
        rng.randn(*v.shape) * 0.02, v.dtype), tree)


def _jax_draws(key, n_rays):
    ks, kg, kf = jax.random.split(key, 3)
    cfg = JRenderConfig(**RENDER_KW)
    return tuple(_t(x) for x in (
        jax.random.uniform(ks, (SB, n_rays, cfg.n_depth_candidates)),
        jax.random.normal(kg, (SB, n_rays, cfg.n_gaussian)),
        jax.random.uniform(kf, (SB, n_rays, cfg.n_samples))))


@pytest.fixture(scope="module", params=["group", "batch"])
def case(request):
    """One norm's JAX results (losses, gradients, one train step) and the
    inputs to give the port."""
    norm = request.param
    jm = _jdiner(norm)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jm.init(jax.random.PRNGKey(0), jbatch, jax.random.PRNGKey(1))
    rng = np.random.RandomState(5)
    params = _perturb(variables["params"], rng)
    stats = variables.get("batch_stats")
    key = jax.random.PRNGKey(3)
    k_pix, k_render = jax.random.split(key)
    pix = jm.apply({"params": params, **({"batch_stats": stats} if stats
                                         else {})},
                   k_pix, jbatch, SB, H, W, method="_select_pixels")

    def loss_fn(p):
        v = {"params": p}
        if stats is not None:
            v["batch_stats"] = stats
            out, _ = jm.apply(v, jbatch, key, train=True, method="losses",
                              mutable=["batch_stats"])
        else:
            out = jm.apply(v, jbatch, key, train=True, method="losses")
        return out["total"], out

    grads, losses = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    tx = make_optimizer(params, LR)
    state = JTrainState(step=0, params=params, batch_stats=stats,
                        opt_state=tx.init(params), tx=tx)
    new_state, step_losses = make_train_step(jm)(
        jax.tree.map(jnp.array, state), jbatch, key)
    sd = from_jax({"params": params, **({"batch_stats": stats} if stats
                                        else {})})
    return dict(norm=norm, batch=batch, sd=sd, pix=_t(pix),
                noise=_jax_draws(k_render, SPATCH * SPATCH),
                losses={k: float(v) for k, v in losses.items()},
                grads=from_jax(grads),
                step_losses={k: float(v) for k, v in step_losses.items()},
                new_sd=from_jax({"params": new_state.params,
                                 **({"batch_stats": new_state.batch_stats}
                                    if stats else {})}))


def _port(case, **kw):
    model = _tdiner(case["norm"], **kw)
    model.load_state_dict(case["sd"])
    return model, to_tensors(case["batch"], "cpu")


def test_losses_match_jax(case):
    model, batch = _port(case)
    out = model.losses(batch, train=True, pix=case["pix"],
                       noise=case["noise"])
    assert set(out) == set(case["losses"]) == {"rgb_fine", "vgg_fine",
                                               "antibias", "total"}
    for k, v in case["losses"].items():
        assert abs(float(out[k].detach()) - v) <= 1e-5 * abs(v) + 1e-6, k


@pytest.mark.parametrize("remat", [False, True])
def test_parameter_gradients_match_jax(case, remat):
    """Every nerf parameter's gradient of the total; remat_field recomputes
    the field MLP in the backward pass and gives the same gradients."""
    model, batch = _port(case, remat_field=remat)
    model.losses(batch, train=True, pix=case["pix"],
                 noise=case["noise"])["total"].backward()
    names = [n for n, _ in model.named_parameters() if n.startswith("nerf.")]
    assert names and all(p.grad is None for p in model.vgg.parameters())
    for name, p in model.named_parameters():
        if not name.startswith("nerf."):
            continue
        ref = case["grads"][name]
        scale = float(ref.abs().max())
        assert scale > 0, name
        err = (p.grad - ref).abs()
        assert bool((err <= 1e-4 * ref.abs() + 1e-4 * scale).all()), \
            (name, float(err.max()), scale)


def test_train_step_matches_optax_and_flax_stats(case):
    """One train step: the losses, Adam's update of every parameter, and
    (batch norm) the running statistics, as flax's batch_stats."""
    model, batch = _port(case)
    state = create_train_state(model, LR)
    out = train_step(state, batch, pix=case["pix"], noise=case["noise"])
    assert out["skipped_nonfinite"] == 0.0 and state.step == 1
    for k, v in case["step_losses"].items():
        if k != "skipped_nonfinite":
            assert abs(out[k] - v) <= 1e-5 * abs(v) + 1e-6, k
    got = model.state_dict()
    n_stats = 0
    for name, ref in case["new_sd"].items():
        if not name.startswith("nerf.") or name.endswith("tracked"):
            continue
        if name.endswith(("running_mean", "running_var")):
            n_stats += 1
            np.testing.assert_allclose(got[name].numpy(), ref.numpy(),
                                       atol=1e-5, err_msg=name)
            continue
        g = case["grads"][name].abs()
        tol = torch.where(g > 1e-4 * g.max(), 1e-5, 2 * LR + 1e-6)
        assert bool(((got[name] - ref).abs() <= tol).all()), name
    assert n_stats == (2 * 7 if case["norm"] == "batch" else 0)


def test_batchnorm_running_stats_follow_flax():
    """The port's BatchNorm in train mode: output as torch's, running mean
    and BIASED running variance with flax's momentum 0.9 (torch's
    BatchNorm2d would update with the unbiased variance); eval unchanged."""
    from flax import linen as fnn

    rng = np.random.RandomState(2)
    x = rng.randn(3, 5, 6, 4).astype(np.float32) * 2.0 + 1.0   # NHWC
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), x)
    y, mut = bn.apply(v, x, mutable=["batch_stats"])
    port = BatchNorm(4, eps=1e-5, momentum=0.1).train()
    out = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y),
                               atol=1e-5)
    for leaf, buf in (("mean", port.running_mean),
                      ("var", port.running_var)):
        np.testing.assert_allclose(buf.numpy(), np.asarray(
            mut["batch_stats"][leaf]), rtol=1e-6, atol=1e-7)
    assert int(port.num_batches_tracked) == 1
    port.eval()
    ref = torch.nn.functional.batch_norm(
        _t(x).permute(0, 3, 1, 2), port.running_mean, port.running_var,
        port.weight, port.bias, False, 0.0, 1e-5)
    assert torch.equal(port(_t(x).permute(0, 3, 1, 2)), ref)


def test_composite_plain_backward_matches_jax_grad():
    """K4's plain backward (autograd through composite_rays_plain) against
    jax.grad of composite_outputs, with sigma exactly 0 in places (both
    split the tie of relu evenly): 1e-6 abs + 1e-5 rel."""
    from diner_tpu_torch.kernels.cases import composite_grad_inputs

    for white in (False, True):
        rays, z, out, g_rgb, g_d, g_a = composite_grad_inputs(3, 2, 23, 13)
        assert (out[..., 3] == 0).any()

        def f(o):
            w, rgb, depth = j_composite(jnp.asarray(rays), jnp.asarray(z), o,
                                        white)
            return (jnp.sum(rgb * g_rgb) + jnp.sum(depth * g_d)
                    + jnp.sum(w.sum(-1) * g_a))

        ref = np.asarray(jax.grad(f)(jnp.asarray(out)))
        got = composite_rays_backward_plain(*(_t(x) for x in (
            rays, z, out, g_rgb, g_d, g_a)), white)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("schedule", [
    dict(), dict(lr_schedule="cosine", lr_decay_steps=5),
    dict(lr_schedule="cosine", lr_decay_steps=6, lr_warmup_steps=2)],
    ids=["constant", "cosine", "warmup_cosine"])
def test_adam_and_schedules_match_optax(schedule):
    """Eight Adam steps on the same gradients: the port's optimizer and
    LambdaLR against optax.adam with the JAX package's schedule, past the
    end of the decay, parameters within 1e-7."""
    rng = np.random.RandomState(4)
    p0 = rng.randn(3, 4).astype(np.float32)
    grads = [rng.randn(3, 4).astype(np.float32) for _ in range(8)]
    jparams = {"nerf": {"w": jnp.asarray(p0)}}
    tx = make_optimizer(jparams, LR, **schedule)
    opt_state = tx.init(jparams)

    class Toy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.nerf = torch.nn.ParameterDict(
                {"w": torch.nn.Parameter(_t(p0))})

    model = Toy()
    state = create_train_state(model, LR, **schedule)
    for g in grads:
        upd, opt_state = tx.update({"nerf": {"w": jnp.asarray(g)}},
                                   opt_state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        model.nerf["w"].grad = _t(g)
        state.optimizer.step()
        state.scheduler.step()
        np.testing.assert_allclose(model.nerf["w"].detach().numpy(),
                                   np.asarray(jparams["nerf"]["w"]),
                                   atol=1e-7)


def test_schedule_checks():
    with pytest.raises(ValueError, match="lr_decay_steps"):
        lr_factor("cosine")
    with pytest.raises(ValueError):
        lr_factor("cosine", lr_decay_steps=4, lr_warmup_steps=4)
    with pytest.raises(ValueError, match="unknown"):
        lr_factor("linear")
    f = lr_factor("cosine", lr_decay_steps=10, lr_warmup_steps=2)
    assert f(0) == 0.0 and f(1) == 0.5 and f(2) == 1.0
    assert f(10) == pytest.approx(0.01) and f(100) == pytest.approx(0.01)


def test_nan_guard_rolls_everything_back():
    """A non-finite total skips the batch: parameters, Adam's moments and
    step count, the schedule and the BatchNorm running statistics stay as
    they were after the previous (finite) step; skipped_nonfinite is 1."""
    model = _tdiner("batch")
    state = create_train_state(model, LR)
    batch = to_tensors(_batch(), "cpu")
    gen = torch.Generator().manual_seed(0)
    assert train_step(state, batch, generator=gen)["skipped_nonfinite"] == 0
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = {i: {n: t.clone() for n, t in s.items()}
           for i, s in state.optimizer.state_dict()["state"].items()}
    assert any(k.endswith("running_var") for k in before)
    bad = dict(batch, src_rgbs=batch["src_rgbs"].clone())
    bad["src_rgbs"][0, 0, 0, 0, 0] = float("nan")
    out = train_step(state, bad, generator=gen)
    assert out["skipped_nonfinite"] == 1.0 and not np.isfinite(out["total"])
    assert state.step == 1 and state.scheduler.last_epoch == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for i, s in state.optimizer.state_dict()["state"].items():
        for n, t in s.items():
            assert torch.equal(t, opt[i][n]), (i, n)


def test_loader_order_matches_jax():
    """Per-epoch RandomState(seed + epoch) shuffling, drop_last: the port's
    batches hold the JAX loader's samples in its order, over 2 epochs."""
    ds = JDataset(n_scenes=7, n_views=2, H=8, W=8, seed=3)
    for seed in (0, 5):
        jl = JBatchLoader(ds, batch_size=2, shuffle=True, seed=seed,
                          num_threads=2)
        tl = BatchLoader(ds, batch_size=2, shuffle=True, seed=seed,
                         num_threads=2)
        assert len(tl) == len(jl) == 3
        for _ in range(2):
            got, ref = list(tl), list(jl)
            assert len(got) == len(ref) == 3
            for a, b in zip(got, ref):
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
    for n, pc in ((127, 8), (5, 3), (0, 2)):
        for pi in range(pc):
            for pad in (False, True):
                assert process_local_slice(n, pi, pc, pad) == \
                    j_process_local_slice(n, pi, pc, pad)


class _Toy(torch.nn.Module):
    """A model with DINER's training interface and no draws."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.nerf = torch.nn.Linear(4, 4)

    def losses(self, batch, train=True, pix=None, noise=None,
               generator=None):
        return {"total": ((self.nerf(batch["x"]) - batch["y"]) ** 2).mean()}


def test_periodic_checkpoint_resume_does_not_replay_steps(tmp_path):
    """As tests/test_train.py's: the periodic checkpoint labelled 2 of a
    4-step run holds the parameters of 2 completed steps, and resuming it
    for steps 2 and 3 equals a straight 4-step run bitwise."""
    rs = np.random.RandomState(0)
    batch = {"x": rs.randn(2, 4).astype(np.float32),
             "y": rs.randn(2, 4).astype(np.float32)}

    def run(d, steps, **kw):
        return train(_Toy(), itertools.repeat(batch), tmp_path / d,
                     max_steps=steps, log_every=10, device="cpu", lr=1e-2,
                     **kw)

    straight2 = run("a", 2, ckpt_every=0)
    run("b", 4, ckpt_every=2)
    assert ckpt_io.all_steps(tmp_path / "b" / "ckpts") == [2, 4]
    fresh = create_train_state(_Toy())
    assert restore_checkpoint(tmp_path / "b" / "ckpts", fresh, step=2) == 2
    for a, b in zip(straight2.model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b)
    straight4 = run("c", 4, ckpt_every=0)
    (tmp_path / "b" / "ckpts" / "step_00000004.pt").unlink()
    resumed = run("b", 4, ckpt_every=0, resume=True)
    assert resumed.step == 4
    for a, b in zip(straight4.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)
    steps = [json.loads(x)["step"] for x in
             (tmp_path / "b" / "metrics.jsonl").read_text().splitlines()]
    assert steps == [0, 3, 3]   # log_every 10: step 0 and each last step
    # a no-op resume of a finished run saves nothing new
    run("b", 4, ckpt_every=0, resume=True)
    assert ckpt_io.all_steps(tmp_path / "b" / "ckpts") == [2, 4]


def test_final_checkpoint_saved_before_final_validation(tmp_path):
    """A validation that fails (a full render is a likely place to run out
    of memory) cannot lose the run: the final checkpoint is written first,
    and the in-loop validation runs at every val_every-th step."""
    batch = {"x": np.ones((2, 4), np.float32),
             "y": np.zeros((2, 4), np.float32)}
    seen = []

    def val_fn(state, step):
        seen.append((step, state.step))
        if step == 5:
            raise RuntimeError("validation failed")

    with pytest.raises(RuntimeError, match="validation failed"):
        train(_Toy(), itertools.repeat(batch), tmp_path, max_steps=5,
              val_every=2, val_fn=val_fn, ckpt_every=0, device="cpu")
    assert seen == [(2, 3), (4, 5), (5, 5)]
    assert ckpt_io.all_steps(tmp_path / "ckpts") == [5]


def test_eval_step_leaves_the_model_as_it_was(case):
    """eval_step: the losses of the norms in eval mode with no gradient and
    no change to the running statistics; the same draws give the same
    losses."""
    model, batch = _port(case)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    a = eval_step(model, batch, pix=case["pix"], noise=case["noise"])
    b = eval_step(model, batch, pix=case["pix"], noise=case["noise"])
    assert a == b and np.isfinite(a["total"])
    assert all(p.grad is None for p in model.parameters())
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    if case["norm"] == "group":   # no running statistics: train mode agrees
        assert a["total"] == pytest.approx(case["losses"]["total"],
                                           rel=1e-5)


def test_optimizer_state_adopted_only_on_matching_layout(tmp_path, capsys):
    state = create_train_state(_Toy())
    state.model.nerf.weight.grad = torch.ones(4, 4)
    state.model.nerf.bias.grad = torch.ones(4)
    state.optimizer.step()
    payload = {"optimizer": state.optimizer.state_dict()}
    other = create_train_state(_Toy())
    assert ckpt_io.adopt_opt_state(payload, other.optimizer)
    assert torch.equal(other.optimizer.state_dict()["state"][0]["exp_avg"],
                       state.optimizer.state_dict()["state"][0]["exp_avg"])

    class Wider(_Toy):
        def __init__(self):
            super().__init__()
            self.nerf = torch.nn.Linear(4, 5)

    wider = create_train_state(Wider())
    assert not ckpt_io.adopt_opt_state(payload, wider.optimizer)
    assert not ckpt_io.adopt_opt_state({}, wider.optimizer)
    assert "reinitializing" in capsys.readouterr().out
    assert wider.optimizer.state_dict()["state"] == {}


def test_select_pixels_patches_inside_border_on_fg():
    """Each sample's patch is vgg_spatch^2 pixels of one square, inside the
    image, its centre on a foreground pixel at least (spatch + 1) // 2 px
    from the border; with erode_fg_mask the centre lies where the eroded
    alpha is nonzero. Without patch losses: ray_batch_size random pixels."""
    s, pad = 8, 4
    yy, xx = np.mgrid[:H, :W]
    r = np.sqrt((yy - 20) ** 2 + (xx - 12) ** 2)
    ring = (np.abs(r - 6.0) < 0.8).astype(np.float32)
    disk = (r < 2.5).astype(np.float32)
    alpha = np.maximum(ring, disk)
    alpha[:, :3] = 1.0   # foreground inside the border: never a centre
    batch = {"target_rgb": torch.zeros(1, H, W, 3),
             "target_alpha": _t(alpha[None, ..., None])}
    for erode, allowed in ((0, alpha), (1, disk)):
        model = _tdiner("group")
        model.erode_fg_mask = erode
        gen = torch.Generator().manual_seed(erode)
        hits = np.zeros((H, W), bool)
        for _ in range(64):
            pix = model._select_pixels(batch, 1, H, W, gen)[0].numpy()
            assert pix.shape == (s * s,)
            px, py = pix % W, pix // W
            assert 0 <= px.min() and px.max() < W
            assert 0 <= py.min() and py.max() < H
            cx, cy = px[0] + pad, py[0] + pad
            assert (px.reshape(s, s) == px[0] + np.arange(s)).all()
            assert (py.reshape(s, s).T == py[0] + np.arange(s)).all()
            assert pad <= cx < W - pad and pad <= cy < H - pad
            assert allowed[cy, cx] > 0
            hits[cy, cx] = True
        assert hits[ring > 0].any() == (erode == 0)
    model = _tdiner("group")
    model.w_vgg = model.w_antibias = 0.0
    pix = model._select_pixels(batch, 2, H, W, torch.Generator())
    assert pix.shape == (2, model.ray_batch_size)
    assert pix.min() >= 0 and pix.max() < H * W


def test_vgg_tower_and_losses_match_jax():
    """The VGG tower from flax params (1e-4 abs: 9 convolutions in another
    order), avg_pool2d, the antibias loss and the perceptual loss with
    detached targets (1e-5 rel)."""
    rng = np.random.RandomState(6)
    pred = rng.rand(2, 16, 16, 3).astype(np.float32)
    gt = rng.rand(2, 16, 16, 3).astype(np.float32)
    jvgg = JVgg()
    params = jvgg.init(jax.random.PRNGKey(0), jnp.asarray(pred))["params"]
    vgg = Vgg19Features()
    vgg.load_state_dict(from_jax(params))
    assert not any(p.requires_grad for p in vgg.parameters())
    ref = jvgg.apply({"params": params}, jnp.asarray(pred))
    got = vgg(_t(pred))
    assert len(got) == 4
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)
    np.testing.assert_allclose(avg_pool2d(_t(pred), 4).numpy(), np.asarray(
        j_avg_pool2d(jnp.asarray(pred), 4)), atol=1e-7)
    assert float(antibias_loss(_t(pred), _t(gt), 2)) == pytest.approx(
        float(j_antibias_loss(jnp.asarray(pred), jnp.asarray(gt), 2)),
        rel=1e-5)
    pred_t = _t(pred).requires_grad_(True)
    loss = vgg_perceptual_loss(vgg, pred_t, _t(gt))
    jloss = j_vgg_loss(lambda x: jvgg.apply({"params": params}, x),
                       jnp.asarray(pred), jnp.asarray(gt))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    loss.backward()
    assert pred_t.grad is not None and torch.isfinite(pred_t.grad).all()


def test_lightning_vgg_round_trip():
    """vggloss.vgg_net.slice* of a reference checkpoint: from_lightning
    gives the JAX port's VGG params (as from_jax maps them) bitwise, and
    to_lightning of a DINER with that tower gives export_diner's keys and
    values back."""
    rng = np.random.RandomState(1)
    sd = _fake_lightning_sd()
    for name, idx in (("conv1_1", 0), ("conv1_2", 2), ("conv2_1", 5),
                      ("conv2_2", 7), ("conv3_1", 10), ("conv3_2", 12),
                      ("conv3_3", 14), ("conv3_4", 16), ("conv4_1", 19)):
        conv = getattr(Vgg19Features(), name)
        s = 1 + (idx > 0) + (idx > 5) + (idx > 10)
        sd[f"vggloss.vgg_net.slice{s}.{idx}.weight"] = rng.randn(
            *conv.weight.shape).astype(np.float32)
        sd[f"vggloss.vgg_net.slice{s}.{idx}.bias"] = rng.randn(
            *conv.bias.shape).astype(np.float32)
    variables, jextras = port_diner_checkpoint(sd)
    port_sd, extras = from_lightning(sd)
    ref = from_jax(jextras["vgg_params"])
    assert extras["vgg_params"].keys() == ref.keys()
    for k, v in ref.items():
        assert torch.equal(extras["vgg_params"][k], v), k
    model = DINER(PixelNeRF(encoder_norm="batch", sigma_activation="relu"),
                  znear=extras["znear"], zfar=extras["zfar"], w_vgg=0.1)
    model.nerf.load_state_dict(port_sd)
    model.vgg.load_state_dict(extras["vgg_params"])
    out = to_lightning(model)
    jout = export_diner(variables, extras["znear"], extras["zfar"],
                        vgg_params=jextras["vgg_params"])
    assert out.keys() == jout.keys()
    for k, v in jout.items():
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(v), k)


def test_from_jax_takes_a_whole_diner_variables_tree():
    """A JAX DINER's variables (nerf params, vgg params, batch stats) load
    strictly into the port's DINER."""
    jm = _jdiner("batch")
    jbatch = {k: jnp.asarray(v) for k, v in _batch().items()}
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jbatch,
                                 jax.random.PRNGKey(1))
    sd = from_jax(variables)
    assert any(k.startswith("vgg.") for k in sd)
    assert any(k.endswith("running_var") for k in sd)
    _tdiner("batch").load_state_dict(sd)
    with pytest.raises(ValueError):
        from_jax(variables, variables["batch_stats"])


def test_train_cli_on_cpu_then_render_eval_ckpt(tmp_path, capsys):
    """python -m diner_tpu_torch.cli.train configs/train_synthetic.yaml
    --max-steps 3 --device cpu: metrics.jsonl, a checkpoint at step 3 and
    its validation with the config's cam sweep; then cli.render_eval --ckpt renders and scores from
    it; a resume to 4 steps replays none."""
    from pathlib import Path

    cfg = Path(__file__).resolve().parent.parent / "configs" / \
        "train_synthetic.yaml"
    run = tmp_path / "run"
    state = train_cli.main([str(cfg), "--run-dir", str(run), "--max-steps",
                            "3", "--device", "cpu"])
    assert state.step == 3
    sweeps = run / "eval_000003" / "cam_sweeps"
    assert sorted(p.name for p in sweeps.iterdir()) == [
        "synthetic_0000-ref_imgs.jpg", "synthetic_0000.mp4"]
    assert (run / "config.yaml").exists() and (run / "GIT_REVISION").exists()
    lines = [json.loads(x) for x in
             (run / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [0, 2, 3]
    assert all(np.isfinite(x["total"]) for x in lines[:2])
    assert "valscores_psnr" in lines[2]
    assert ckpt_io.all_steps(run / "ckpts") == [3]
    scores = render_eval.main(["--config", str(cfg), "--ckpt",
                               str(run / "ckpts"), "--out",
                               str(tmp_path / "eval"), "--n", "1",
                               "--device", "cpu"])
    assert "step 3" in capsys.readouterr().out
    assert set(scores) == {"ssim", "psnr", "l2", "l1"}
    assert all(np.isfinite(v) for v in scores.values())
    assert len(list((tmp_path / "eval" / "visualizations").iterdir())) == 4
    state = train_cli.main([str(cfg), "--run-dir", str(run), "--max-steps",
                            "4", "--resume", "--device", "cpu"])
    assert state.step == 4 and ckpt_io.all_steps(run / "ckpts") == [3, 4]


def test_train_entry_points_need_cuda_unless_asked(monkeypatch, tmp_path):
    """cli.train and train() default to CUDA and raise without it, with
    --multihost too (a rank takes its card); _resolve_val_every reads
    Lightning's val_check_interval."""
    from pathlib import Path

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Path(__file__).resolve().parent.parent / "configs" / \
        "train_synthetic.yaml"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main([str(cfg), "--run-dir", str(tmp_path / "r")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(_Toy(), [], tmp_path / "t")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main([str(cfg), "--multihost"])
    loader = list(range(8))
    assert train_cli._resolve_val_every(None, loader) is None
    assert train_cli._resolve_val_every(0.25, loader) == 2
    assert train_cli._resolve_val_every(1.0, loader) == 8
    assert train_cli._resolve_val_every(30000, loader) == 30000
