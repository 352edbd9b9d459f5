"""The port's initial DINER weights against the JAX package's, by
distribution.

Both packages build DINER at configs/plateau/base6k.yaml's widths from their
own seeds (JAX: `create_train_state` at PRNGKey(0); the port: `cli/build`'s
`build_diner` after torch.manual_seed(0), as `cli/train` does), with the VGG
tower of the perceptual loss switched on (w_vgg 0.1) so that it is held too,
and once with the encoder's batch norm. JAX's tensors are carried to the
port's names and layouts by `models/from_jax.py`. For every tensor:
- a tensor that is constant in JAX (norm scales and shifts, biases, the
  zero-initialized `fc_1`s, `lin_out`'s bias (0, 0, 0, 0.5), running
  statistics) is equal exactly, and the output rows that are all zero are
  the same rows (ResnetFC's zeroed sigma row of `lin_out`);
- over the other rows, the means differ by at most 4 standard errors of
  the difference, and so do the standard deviations (the standard error of
  a sample std taken as std / sqrt(2 n)), and so does the share of entries
  more than 2 JAX standard deviations from the mean (binomial standard
  errors), which tells flax's truncated `lecun_normal` from a plain normal
  of the same variance.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from diner_tpu.cli.build import build_dataset as j_build_dataset
from diner_tpu.cli.build import build_diner as j_build_diner
from diner_tpu.core.config import load_config as j_load_config
from diner_tpu.data import collate as j_collate
from diner_tpu.data import to_device_batch
from diner_tpu.train.state import create_train_state
from diner_tpu_torch.cli.build import build_diner
from diner_tpu_torch.core.config import load_config
from diner_tpu_torch.models import from_jax

CONFIG = "configs/plateau/base6k.yaml"
N_SE = 4.0


def _with(conf, norm):
    conf = copy.deepcopy(conf)
    conf["optimizer"]["kwargs"]["w_vgg"] = 0.1
    conf["nerf"]["kwargs"]["encoder_conf"]["kwargs"]["norm"] = norm
    return conf


def _jax_state_dict(norm):
    conf = _with(j_load_config(CONFIG), norm)
    dconf = copy.deepcopy(conf["data"]["train"])
    dconf["dataset"]["kwargs"].update(n_scenes=1, H=32, W=32)
    ds = j_build_dataset(dconf, stage="train")
    model = j_build_diner(conf, znear=ds.znear, zfar=ds.zfar)
    batch = to_device_batch(j_collate([ds[0]]))
    state = create_train_state(model, jax.random.PRNGKey(0), batch)
    variables = {"params": state.params}
    if state.batch_stats:
        variables["batch_stats"] = state.batch_stats
    return from_jax(jax.device_get(variables))


def _port_state_dict(norm):
    conf = _with(load_config(CONFIG), norm)
    torch.manual_seed(0)
    model = build_diner(conf, znear=0.5, zfar=2.5)
    return model.state_dict()


def _stats_agree(name, want, got):
    n = want.size
    mj, mt = want.mean(), got.mean()
    sj, st = want.std(), got.std()
    assert abs(mj - mt) <= N_SE * np.sqrt((sj ** 2 + st ** 2) / n), \
        f"{name}: mean {mt:.4g} vs JAX {mj:.4g}"
    assert abs(sj - st) <= N_SE * np.sqrt((sj ** 2 + st ** 2) / (2 * n)), \
        f"{name}: std {st:.4g} vs JAX {sj:.4g}"
    tj = np.mean(np.abs(want - mj) > 2 * sj)
    tt = np.mean(np.abs(got - mj) > 2 * sj)
    se = np.sqrt((tj * (1 - tj) + tt * (1 - tt)) / n)
    assert abs(tj - tt) <= N_SE * max(se, 1.0 / n), \
        f"{name}: share beyond 2 std {tt:.4f} vs JAX {tj:.4f}"


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_initial_weights_match_jax_in_distribution(norm):
    want_sd = _jax_state_dict(norm)
    got_sd = _port_state_dict(norm)
    assert sorted(want_sd) == sorted(got_sd)
    n_random = 0
    for name, w in want_sd.items():
        want = w.double().numpy()
        got = got_sd[name].double().numpy()
        assert want.shape == got.shape, name
        if name.endswith("num_batches_tracked") or want.std() == 0:
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        zero_rows = (want == 0).reshape(len(want), -1).all(1)
        np.testing.assert_array_equal(
            (got == 0).reshape(len(got), -1).all(1), zero_rows, err_msg=name)
        _stats_agree(name, want[~zero_rows].ravel(), got[~zero_rows].ravel())
        n_random += 1
    # the encoder, ResnetFC and the VGG tower each hold random tensors
    for part in ("nerf.encoder.", "nerf.mlp.", "vgg."):
        assert any(k.startswith(part) for k in want_sd), part
    assert n_random > 40
