"""diner_tpu_torch.mvs (TransMVSNet inference) and cli/mvs against diner_tpu
on the CPU.

JAX's variable tree comes from `jax.eval_shape(net.init, ...)` filled from a
numpy seed (its `init` is never called: it takes minutes on the CPU), with
every leaf random: BatchNorm variances positive, and the DCN offset convs
drawn so that taps move by up to about 2 px, some past the image edge (the
init zeroes them). One jitted apply, shared by every cascade test,
returns the outputs and every module's intermediate outputs.

Tolerances (float32):
- 1e-5 abs for the elementwise ops, gathers and resizes (the frameworks
  round sums at other places: a few ulps);
- 1e-4 abs + 1e-4 rel for the conv stacks (FeatureNet, FMT, Deconv3d):
  long accumulations in another order;
- the cascade, per stage: hypotheses within 1e-5, prob_volume within
  1e-5 + 1e-4 |jax|, confidence within 1e-5, and the WTA winner equal
  wherever the two largest probabilities differ by more than 1e-5
  (elsewhere a rounding may pick the other hypothesis), its depth then the
  same hypothesis within 1e-5;
- the CLIs' PNGs and PFMs: decoded equal where the two packages' depths
  are equal, the confidence PNGs within one unit (1e-4) everywhere.
"""

import json
import shutil
import sys
from pathlib import Path

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from diner_tpu.data import codecs as j_codecs
from diner_tpu.mvs import datasets as j_datasets
from diner_tpu.mvs.fmt import (linear_attention as j_linear_attention,
                               sine_position_encoding_2d as j_sine_pe)
from diner_tpu.mvs.layers import Deconv3dBnRelu as JDeconv3dBnRelu
from diner_tpu.mvs.net import TransMVSNet as JTransMVSNet
from diner_tpu.mvs.ops import (deform_conv2d as j_deform_conv2d,
                               depth_range_samples as j_depth_range_samples,
                               depth_wta as j_depth_wta,
                               homo_warping as j_homo_warping)
from diner_tpu.mvs.torch_port import export_transmvsnet
from diner_tpu.mvs.write_prediction import (
    write_depth_prediction as j_write_depth_prediction)
from diner_tpu_torch.cli import mvs as mvs_cli
from diner_tpu_torch.data import codecs
from diner_tpu_torch.mvs import (TransMVSNet, deform_conv2d,
                                 depth_range_samples, depth_wta, from_jax,
                                 homo_warping, load_reference_state_dict,
                                 to_reference_state_dict)
from diner_tpu_torch.mvs import datasets
from diner_tpu_torch.mvs.fmt import linear_attention, sine_position_encoding_2d
from diner_tpu_torch.mvs.layers import Deconv3dBnRelu
from diner_tpu_torch.mvs.write_prediction import write_depth_prediction

sys.path.insert(0, str(Path(__file__).parent))
from test_data import _make_fake_dtu  # noqa: E402
from test_facescape import _make_fake_facescape  # noqa: E402
from test_multiface import _make_fake_multiface  # noqa: E402
from test_mvs_cli import _cams as _eval_cams  # noqa: E402

ARCH = dict(ndepths=(8, 8, 8), depth_intervals_ratio=(4, 2, 1),
            cr_base_chs=(4, 4, 4), base_channels=4)
CLI_ARCH = ["--ndepths", "8,8,8", "--depth_inter_r", "4,2,1",
            "--cr_base_chs", "4,4,4", "--base_channels", "4",
            "--numdepth", "32"]
NUMDEPTH = 32
# the writers' view count: every cascade test shares one compiled JAX apply
NV = 4
# the DTU corner cams in the writer's (non-train) mode
DTU_CORNERS = (10, 30, 6, 35)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's cascade at these sizes is many small ops: one intra-op
    thread runs them fastest, and spares the cores of the other test
    workers (with all of them, each op's thread team waits on cores those
    workers hold)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _random_variables(net, example, seed=0):
    """net's {"params", "batch_stats"} from eval_shape, every leaf drawn
    from a numpy seed."""
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), *example)
    rng = np.random.RandomState(seed)

    def draw(path, s):
        names = [p.key for p in path]
        shape, leaf = s.shape, names[-1]
        if leaf == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if leaf in ("mean", "bias"):
            out = rng.randn(*shape) * 0.1
            if "conv_offset_mask" in names:    # offsets, then mask logits
                out[: 2 * shape[0] // 3] = rng.uniform(-1.5, 1.5,
                                                       2 * shape[0] // 3)
            return out.astype(np.float32)
        if leaf == "scale":
            return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        std = np.sqrt(2.0 / fan_in)
        if "conv_offset_mask" in names:
            std *= 0.5
        return (rng.randn(*shape) * std).astype(np.float32)

    tree = {k: shapes[k] for k in ("params", "batch_stats")}
    return jax.tree_util.tree_map_with_path(draw, tree)


def _projs(V, H, W, baseline=0.08, f=40.0):
    """Stage-scaled [extrinsics, K4] stacks (1, V, 2, 4, 4) of V cams on a
    lateral baseline."""
    out = {}
    for si, scale in enumerate((4, 2, 1)):
        K4 = np.eye(4, dtype=np.float32)
        K4[0, 0] = K4[1, 1] = f / scale
        K4[0, 2], K4[1, 2] = W / (2 * scale), H / (2 * scale)
        stack = []
        for v in range(V):
            ext = np.eye(4, dtype=np.float32)
            ext[0, 3] = baseline * (v - 1)
            stack.append(np.stack([ext, K4]))
        out[f"stage{si + 1}"] = np.stack(stack)[None]
    return out


def _cascade_inputs(V, H=32, W=32, seed=0):
    rng = np.random.RandomState(seed)
    imgs = rng.rand(1, V, H, W, 3).astype(np.float32)
    dv = np.linspace(1.0, 2.0, NUMDEPTH, dtype=np.float32)[None]
    return imgs, _projs(V, H, W), dv


@pytest.fixture(scope="module")
def cascade():
    """(JAX variables, jitted JAX apply -> (outputs, the FeatureNet and
    FMTWithPathway outputs), the port's net with the same weights)."""
    net = JTransMVSNet(**ARCH)
    imgs, projs, dv = _cascade_inputs(NV)
    variables = _random_variables(net, (imgs, projs, dv))

    @jax.jit
    def apply(variables, imgs, projs, dv):
        out, state = net.apply(variables, imgs, projs, dv,
                               capture_intermediates=True,
                               mutable=["intermediates"])
        inter = state["intermediates"]
        return out, {k: inter[k]["__call__"][0]
                     for k in ("feature", "fmt_with_pathway")}

    port = TransMVSNet(**ARCH).eval()
    port.load_state_dict(from_jax(variables))
    return variables, apply, port


def _run_jax(cascade, imgs, projs, dv):
    variables, apply, _ = cascade
    return jax.device_get(apply(variables, imgs, projs, dv))


def _run_port(net, imgs, projs, dv):
    with torch.no_grad():
        return net(_t(imgs).permute(0, 1, 4, 2, 3),
                   {k: _t(v) for k, v in projs.items()}, _t(dv))


# -- ops -------------------------------------------------------------------

def test_deform_conv2d_matches_jax():
    """Offsets up to 2.5 px, so that taps cross cell and image edges; some
    land exactly on pixels and on the clip bounds."""
    rng = np.random.RandomState(0)
    N, H, W, C, O, K = 2, 7, 9, 3, 4, 3
    x = rng.randn(N, H, W, C).astype(np.float32)
    offset = rng.uniform(-2.5, 2.5, (N, H, W, 2 * K * K)).astype(np.float32)
    offset[0, :2] = np.round(offset[0, :2])
    # tap 0 of pixel (0, 0) at (-2, W): clipped to (-1, W), fully outside
    offset[1, 0, 0, :2] = [-1.0, float(W) + 1]
    mask = rng.rand(N, H, W, K * K).astype(np.float32)
    weight = rng.randn(K, K, C, O).astype(np.float32)
    bias = rng.randn(O).astype(np.float32)
    ref = np.asarray(jax.jit(j_deform_conv2d)(x, offset, mask, weight, bias))
    got = deform_conv2d(_t(x).permute(0, 3, 1, 2),
                        _t(offset).permute(0, 3, 1, 2),
                        _t(mask).permute(0, 3, 1, 2),
                        _t(weight).permute(3, 2, 0, 1), _t(bias))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-5)


@pytest.mark.parametrize("per_pixel", [False, True])
def test_homo_warping_matches_jax(per_pixel):
    """Rotated and translated cams; depths through 0 so that some points
    fall behind the camera (z < 1e-6 reads zeros) and many off the image."""
    rng = np.random.RandomState(1)
    B, H, W, C, D = 2, 6, 8, 3, 5
    fea = rng.randn(B, H, W, C).astype(np.float32)
    projs = []
    for _ in range(2 * B):
        q, _ = np.linalg.qr(rng.randn(3, 3) * 0.1 + np.eye(3))
        P = np.eye(4, dtype=np.float32)
        K = np.array([[6.0, 0, W / 2], [0, 6.0, H / 2], [0, 0, 1]])
        P[:3, :4] = K @ np.concatenate([q, rng.randn(3, 1) * 0.3], 1)
        projs.append(P.astype(np.float32))
    src, ref = np.stack(projs[:B]), np.stack(projs[B:])
    if per_pixel:
        dv = rng.uniform(-0.5, 3.0, (B, D, H, W)).astype(np.float32)
    else:
        dv = np.linspace(-0.2, 3.0, D, dtype=np.float32)[None].repeat(B, 0)
    want = np.asarray(jax.jit(j_homo_warping)(fea, src, ref, dv))
    got = homo_warping(_t(fea).permute(0, 3, 1, 2), _t(src), _t(ref), _t(dv))
    got = got.permute(0, 2, 3, 4, 1).numpy()
    assert (want == 0).all(axis=-1).any() and (want != 0).any()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_depth_range_samples_and_wta_match_jax():
    rng = np.random.RandomState(2)
    B, H, W, D = 2, 4, 5, 8
    full = np.sort(rng.uniform(1, 3, (B, 32)), axis=1).astype(np.float32)
    cur = rng.uniform(1, 3, (B, H, W)).astype(np.float32)
    step = rng.uniform(0.01, 0.1, (B, 1, 1)).astype(np.float32)
    for cur_depth in (full, cur):
        want = np.asarray(jax.jit(j_depth_range_samples,
                                  static_argnums=(1, 3))(cur_depth, D, step,
                                                         (B, H, W)))
        got = depth_range_samples(_t(cur_depth), D, _t(step), (B, H, W))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    prob = rng.rand(B, D, H, W).astype(np.float32)
    prob[0, 3, 0, 0] = prob[0, 6, 0, 0] = 2.0          # ties: the first wins
    prob[1, 0, 2, 2] = prob[1, 7, 2, 2] = 2.0
    dv = rng.rand(B, D, H, W).astype(np.float32)
    want = np.asarray(jax.jit(j_depth_wta)(prob, dv))
    got = depth_wta(_t(prob), _t(dv)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 0] == dv[0, 3, 0, 0] and got[1, 2, 2] == dv[1, 0, 2, 2]


def test_linear_attention_and_position_encoding_match_jax():
    rng = np.random.RandomState(3)
    q, k = rng.randn(2, 7, 2, 4), rng.randn(2, 9, 2, 4)
    v = rng.randn(2, 9, 2, 5)
    want = np.asarray(jax.jit(j_linear_attention)(
        *(jnp.asarray(a, jnp.float32) for a in (q, k, v))))
    np.testing.assert_allclose(linear_attention(_t(q), _t(k), _t(v)).numpy(),
                               want, atol=1e-5)
    want = np.asarray(jax.jit(j_sine_pe, static_argnums=(0, 1, 2))(32, 10, 12))
    got = sine_position_encoding_2d(32, 10, 12).permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("case", ["linear_down", "linear_up", "nearest_up"])
def test_resizes_match_jax_at_the_borders(case):
    """The cascade's resizes: the depth hypotheses (linear, no antialias,
    /4 and /2), the previous depth (linear, x4 and x2) and the view
    weights (nearest, x2): every pixel, the border rows and columns
    included."""
    rng = np.random.RandomState(4)
    x = rng.rand(2, 3, 16, 20).astype(np.float32)
    if case == "linear_down":
        size = (4, 5)
        want = jax.image.resize(x, (2, 3, *size), "linear", antialias=False)
        got = F.interpolate(_t(x), size=size, mode="bilinear",
                            align_corners=False)
    elif case == "linear_up":
        size = (64, 80)
        want = jax.image.resize(x, (2, 3, *size), "linear")
        got = F.interpolate(_t(x), size=size, mode="bilinear",
                            align_corners=False)
    else:
        size = (32, 40)
        want = jax.image.resize(x, (2, 3, *size), "nearest")
        got = F.interpolate(_t(x), size=size, mode="nearest-exact")
    want = np.asarray(want)
    for sl in (np.s_[..., 0, :], np.s_[..., -1, :], np.s_[..., :, 0],
               np.s_[..., :, -1], np.s_[...]):
        np.testing.assert_allclose(got.numpy()[sl], want[sl], atol=1e-5)


def test_deconv3d_bn_relu_matches_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(1, 4, 4, 6, 8).astype(np.float32)        # N D H W C
    jm = JDeconv3dBnRelu(5)
    variables = _random_variables(jm, (x,), seed=5)
    want = np.asarray(jax.jit(jm.apply)(variables, x))
    pm = Deconv3dBnRelu(8, 5).eval()
    p, s = variables["params"], variables["batch_stats"]
    pm.load_state_dict({
        "conv.weight": _t(p["ConvTranspose_0"]["kernel"]).permute(
            4, 3, 0, 1, 2),
        "bn.weight": _t(p["BatchNorm_0"]["scale"]),
        "bn.bias": _t(p["BatchNorm_0"]["bias"]),
        "bn.running_mean": _t(s["BatchNorm_0"]["mean"]),
        "bn.running_var": _t(s["BatchNorm_0"]["var"]),
        "bn.num_batches_tracked": torch.tensor(0)})
    with torch.no_grad():
        got = pm(_t(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    assert want.shape == (1, 8, 8, 12, 5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


# -- modules and the cascade ----------------------------------------------

@pytest.fixture(scope="module")
def cascade_run(cascade):
    imgs, projs, dv = _cascade_inputs(NV)
    out, inter = _run_jax(cascade, imgs, projs, dv)
    return (imgs, projs, dv), out, inter


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


@pytest.mark.parametrize("module", ["feature", "fmt_with_pathway"])
def test_feature_net_and_fmt_match_jax(cascade, cascade_run, module):
    """FeatureNet on the batched trunk's B*V images, and FMTWithPathway on
    JAX's FeatureNet outputs: the cascade's own intermediates."""
    (imgs, _, _), _, inter = cascade_run
    port = cascade[2]
    feats = inter["feature"]
    V = imgs.shape[1]
    with torch.no_grad():
        if module == "feature":
            got = [port.feature(_nchw(imgs[0]))]
            want = [feats]
        else:
            views = [{k: _nchw(f[v:v + 1]) for k, f in feats.items()}
                     for v in range(V)]
            got = port.FMT_with_pathway(views)
            want = inter["fmt_with_pathway"]
    for g, w in zip(got, want):
        for k in ("stage1", "stage2", "stage3"):
            np.testing.assert_allclose(g[k].permute(0, 2, 3, 1).numpy(),
                                       np.asarray(w[k]), atol=1e-4,
                                       rtol=1e-4, err_msg=f"{module} {k}")


def _assert_stage_matches(got, want, name):
    """The cascade's per-stage tolerance (module docstring)."""
    pv = np.asarray(want["prob_volume"])
    np.testing.assert_allclose(got["depth_values"].numpy(),
                               np.asarray(want["depth_values"]), atol=1e-5,
                               err_msg=f"{name} depth_values")
    np.testing.assert_allclose(got["prob_volume"].numpy(), pv, atol=1e-5,
                               rtol=1e-4, err_msg=f"{name} prob_volume")
    np.testing.assert_allclose(got["photometric_confidence"].numpy(),
                               np.asarray(want["photometric_confidence"]),
                               atol=1e-5, err_msg=f"{name} confidence")
    top2 = np.sort(pv, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-5
    assert clear.mean() > 0.9, f"{name}: too many near-ties to test"
    # the same hypothesis wins, and its depth is that hypothesis's
    np.testing.assert_array_equal(got["prob_volume"].argmax(1).numpy()[clear],
                                  pv.argmax(1)[clear],
                                  err_msg=f"{name} winner")
    np.testing.assert_allclose(got["depth"].numpy()[clear],
                               np.asarray(want["depth"])[clear], atol=1e-5,
                               err_msg=f"{name} depth")


def test_cascade_matches_jax(cascade, cascade_run):
    """4 views at 32x32, ndepths (8, 8, 8), base channels 4: every stage's
    hypotheses, probability volume, confidence and depth."""
    (imgs, projs, dv), want, _ = cascade_run
    got = _run_port(cascade[2], imgs, projs, dv)
    for st in ("stage1", "stage2", "stage3"):
        _assert_stage_matches(got[st], want[st], st)
    np.testing.assert_array_equal(got["depth"].numpy(),
                                  got["stage3"]["depth"].numpy())
    # the probabilities are not flat: the test sees the WTA pick
    assert float(np.asarray(want["photometric_confidence"]).mean()) > 0.2


def test_reference_checkpoint_loads_as_from_jax(cascade, cascade_run,
                                                tmp_path):
    """JAX's export_transmvsnet of the same tree, saved as the reference
    saves checkpoints (half the keys with DDP's "module." prefix), loads
    into the port as from_jax maps it: the same tensors, the same outputs.
    A missing or an unexpected key raises."""
    variables, _, port = cascade
    sd = {("module." + k if i % 2 else k): torch.from_numpy(np.asarray(v))
          for i, (k, v) in enumerate(export_transmvsnet(variables).items())}
    ckpt = tmp_path / "model_000015.ckpt"
    torch.save({"epoch": 15, "model": sd}, ckpt)
    net = TransMVSNet(**ARCH).eval()
    load_reference_state_dict(net, ckpt)
    loaded = net.state_dict()
    for k, v in port.state_dict().items():
        assert torch.equal(loaded[k], v), k
    (imgs, projs, dv), _, _ = cascade_run
    a, b = _run_port(net, imgs, projs, dv), _run_port(port, imgs, projs, dv)
    assert torch.equal(a["depth"], b["depth"])
    bare = {k.replace("module.", ""): v for k, v in sd.items()}
    for broken in ({k: v for k, v in bare.items()
                    if k != "feature.out1.1.weight"},
                   dict(bare, **{"feature.extra.weight": torch.zeros(1)})):
        with pytest.raises(KeyError):
            load_reference_state_dict(TransMVSNet(**ARCH), broken)


def test_to_reference_state_dict_is_export_transmvsnet(cascade):
    """The port's weights in the reference layout: JAX's
    export_transmvsnet of the same variables, key for key and bit for
    bit (bare keys, no BatchNorm step counters)."""
    variables, _, port = cascade
    want = export_transmvsnet(variables)
    for got in (to_reference_state_dict(port),
                to_reference_state_dict(port.state_dict())):
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k].dtype == torch.float32, k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), k)


def test_export_torch_mvs_loads_back(cascade, tmp_path, capsys):
    """`export_torch mvs` on the port's MVS training checkpoint (the newest
    step) writes {"epoch", "model"}, which load_reference_state_dict loads
    back to the same state_dict."""
    from diner_tpu_torch.cli import export_torch
    from diner_tpu_torch.mvs.train import make_optimizer, save_checkpoint

    _, _, port = cascade
    opt = make_optimizer(port, 1e-3)
    save_checkpoint(tmp_path / "ckpts", port, opt, 4)
    save_checkpoint(tmp_path / "ckpts", TransMVSNet(**ARCH), opt, 2)
    out = tmp_path / "transmvsnet.ckpt"
    export_torch.main(["mvs", "--ckpt", str(tmp_path / "ckpts"), "--out",
                       str(out)])
    assert "from step 4" in capsys.readouterr().out
    ckpt = torch.load(out, weights_only=True)
    assert set(ckpt) == {"epoch", "model"} and ckpt["epoch"] == 4
    assert not any(k.startswith("module.") for k in ckpt["model"])
    net = TransMVSNet(**ARCH).eval()
    load_reference_state_dict(net, out)
    want = port.state_dict()
    for k, v in net.state_dict().items():
        assert torch.equal(v, want[k]), k


# -- datasets --------------------------------------------------------------

def _write_dtu_mvs_tree(root):
    """The JAX tests' fake DTU tree, plus 32x32 light-3 images of the corner
    cams (smaller than 512x640, they pass prepare_img whole) and corner
    cam files that see each other (baselines of 40 mm at 425-510 mm)."""
    split_dir = _make_fake_dtu(root)
    rng = np.random.RandomState(7)
    K = np.array([[10.0, 0, 4.0], [0, 10.0, 4.0], [0, 0, 1]])  # 1/4 res
    for i, cam in enumerate(DTU_CORNERS):
        imageio.imwrite(root / "Rectified" / "scan1_train" /
                        f"rect_{cam + 1:03d}_3_r5000.png",
                        rng.randint(0, 255, (32, 32, 3), dtype=np.uint8))
        ext = np.eye(4)
        ext[0, 3], ext[1, 3] = 40.0 * (i % 2), 40.0 * (i // 2)
        codecs.write_mvsnet_cam(root / "Cameras" / "train" /
                                f"{cam:08d}_cam.txt", ext, K, 425.0, 2.5)
    return split_dir / "dtu_val_all.txt"


def _write_eval_tree(root):
    """The JAX eval tests' scan: 4 views at 32x32, cams on an x-baseline."""
    scan = root / "scan9"
    (scan / "images").mkdir(parents=True)
    (scan / "cams").mkdir()
    rng = np.random.RandomState(0)
    exts, K = _eval_cams()
    V = len(exts)
    for v in range(V):
        Image.fromarray((rng.rand(32, 32, 3) * 255).astype(np.uint8)).save(
            scan / "images" / f"{v:08d}.png")
        codecs.write_mvsnet_cam(scan / "cams" / f"{v:08d}_cam.txt", exts[v],
                                K[v], 1.0, 2.0 / 32)
    lines = [str(V)]
    for v in range(V):
        srcs = [s for s in range(V) if s != v]
        lines += [str(v), f"{len(srcs)} " + " ".join(f"{s} 100.0"
                                                     for s in srcs)]
    (scan / "pair.txt").write_text("\n".join(lines) + "\n")
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Pristine DTU, FaceScape and eval trees; the writers run on copies."""
    dtu = tmp_path_factory.mktemp("dtu")
    listfile = _write_dtu_mvs_tree(dtu)
    fs = tmp_path_factory.mktemp("facescape")
    _make_fake_facescape(fs)
    ev = _write_eval_tree(tmp_path_factory.mktemp("eval"))
    return {"dtu": (dtu, listfile), "facescape": (fs, None), "eval": ev}


def _fs_kwargs(meta_dir):
    return {"meta_dir": str(meta_dir), "val_subjects": ["001"],
            "slide_range": 0}


def _dataset_pair(name, trees, tmp_path):
    if name == "dtu":
        root, listfile = trees["dtu"]
        kw = dict(mode="write_prediction", ndepths=NUMDEPTH)
        return (j_datasets.DTUMVSDataset(root, listfile, **kw),
                datasets.DTUMVSDataset(root, listfile, **kw))
    if name == "facescape":
        root = trees["facescape"][0]
        return tuple(cls(root, stage="val", ndepths=NUMDEPTH,
                         **_fs_kwargs(tmp_path / tag))
                     for tag, cls in (("j", j_datasets.FacescapeMVSDataset),
                                      ("t", datasets.FacescapeMVSDataset)))
    if name == "eval":
        return tuple(cls(trees["eval"], ["scan9"], nviews=4, ndepths=NUMDEPTH,
                         img_ext=".png")
                     for cls in (j_datasets.GeneralEvalMVSDataset,
                                 datasets.GeneralEvalMVSDataset))
    root, cfg = _make_fake_multiface(tmp_path / "mf", tmp_path / "mf_meta")
    return tuple(cls(root, stage="val", ndepths=NUMDEPTH, downsample=4,
                     split_config=cfg, meta_dir=tmp_path / tag)
                 for tag, cls in (("j", j_datasets.MultifaceMVSDataset),
                                  ("t", datasets.MultifaceMVSDataset)))


def _assert_equal_samples(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_equal_samples(got[k], v)
        elif isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("name", ["dtu", "facescape", "multiface", "eval"])
def test_mvs_datasets_match_jax(name, trees, tmp_path):
    """Every sample of each MVS dataset equals the JAX one bitwise; the
    registry resolves each by the JAX package's name."""
    from diner_tpu_torch.core.config import resolve

    want_ds, got_ds = _dataset_pair(name, trees, tmp_path)
    assert len(got_ds) == len(want_ds) > 0
    assert resolve(type(got_ds).__name__) is type(got_ds)
    for i in range(len(want_ds)):
        _assert_equal_samples(got_ds[i], want_ds[i])


# -- the CLIs --------------------------------------------------------------

def test_write_prediction_module_matches_jax(tmp_path):
    """The same floats through both packages' write_prediction: the depth,
    confidence and preview PNGs decode equal; save_scene_depth_pfm's PFMs
    (the stage confidences' product, nearest-upsampled) are equal;
    make_proj_matrices gives the same stage stacks."""
    from diner_tpu.mvs.write_prediction import (
        make_proj_matrices as j_make_proj_matrices,
        save_scene_depth_pfm as j_save_scene_depth_pfm)
    from diner_tpu_torch.mvs.write_prediction import (make_proj_matrices,
                                                      save_scene_depth_pfm)

    rng = np.random.RandomState(8)
    depth = rng.uniform(0.3, 7.0, (16, 20)).astype(np.float32)
    depth[0, :3] = 0.0
    conf = rng.rand(16, 20).astype(np.float32)
    mask = rng.rand(16, 20) > 0.2
    for tag, fn in (("j", j_write_depth_prediction),
                    ("t", write_depth_prediction)):
        fn(depth, conf, tmp_path / tag / "depth_map_0030.png",
           scale=872.0 / 0.7, mask=mask)
    for suffix in ("", "_conf", "_vis"):
        name = f"depth_map_0030_TransMVSNet{suffix}.png"
        want = imageio.imread(tmp_path / "j" / name)
        got = codecs.read_png(tmp_path / "t" / name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=name)
    stages = [rng.rand(4, 5), rng.rand(8, 10), conf]
    for tag, fn in (("j", j_save_scene_depth_pfm),
                    ("t", save_scene_depth_pfm)):
        fn(depth, stages, tmp_path / tag / "scan", view_idx=7)
    for sub in ("depth_est", "confidence"):
        name = Path("scan") / sub / "00000007.pfm"
        np.testing.assert_array_equal(
            codecs.read_pfm(tmp_path / "t" / name)[0],
            j_codecs.read_pfm(tmp_path / "j" / name)[0], err_msg=str(name))
    ext = rng.randn(2, 3, 4, 4).astype(np.float32)
    K = rng.rand(2, 3, 3, 3).astype(np.float32) * 100
    want, got = j_make_proj_matrices(ext, K), make_proj_matrices(ext, K)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _ckpt(cascade, path):
    torch.save({"epoch": 0, "model": {
        k: torch.from_numpy(np.asarray(v))
        for k, v in export_transmvsnet(cascade[0]).items()}}, path)
    return path


def _jax_write(cascade, ds, scale):
    """JAX's `mvs write` on `ds` with the cascade's weights (its dataset,
    net and writer), and the port's net on the same samples. Returns
    {dpath: (JAX's depth, the port's depth, where the same stage-3
    hypothesis won, where JAX's two largest probabilities differ by more
    than 1e-5)}."""
    depths = {}
    for i in range(len(ds)):
        s = ds[i]
        batch = (s["imgs"][None],
                 {k: v[None] for k, v in s["proj_matrices"].items()},
                 s["depth_values"][None])
        out, _ = _run_jax(cascade, *batch)
        j_write_depth_prediction(out["depth"][0],
                                 out["photometric_confidence"][0],
                                 s["dpath"], scale=scale)
        port = _run_port(cascade[2], *batch)
        pv = np.asarray(out["stage3"]["prob_volume"][0])
        top2 = np.sort(pv, axis=0)[-2:]
        depths[s["dpath"]] = (
            np.asarray(out["depth"][0]), port["depth"][0].numpy(),
            pv.argmax(0) == port["stage3"]["prob_volume"][0].argmax(0).numpy(),
            top2[1] - top2[0] > 1e-5)
    return depths


@pytest.mark.parametrize("name", ["dtu", "facescape"])
def test_cli_write_matches_jax(name, cascade, trees, tmp_path):
    """`mvs write --device cpu` with the JAX weights (--torch-ckpt, the
    reference layout) writes the priors JAX's writer writes. The same
    stage-3 hypothesis wins (tie-aware), whose depth the two packages
    compute to a few ulps; the decoded depth PNGs are equal wherever the
    depths are, and within one unit wherever the same hypothesis won; the
    preview (scaled by the map's extremes) and confidence PNGs within one
    unit. DTU writes its 4 corner samples at depth / (872 / 0.7),
    FaceScape each view of its camera sets, metric."""
    src, listfile = trees[name]
    j_root, t_root = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(src, j_root)
    shutil.copytree(src, t_root)
    argv = ["write", "--datapath", str(t_root), "--device", "cpu",
            "--torch-ckpt", str(_ckpt(cascade, tmp_path / "m.ckpt"))]
    argv += CLI_ARCH
    if name == "dtu":
        scale = 872.0 / 0.7
        j_ds = j_datasets.DTUMVSDataset(j_root, listfile,
                                        mode="write_prediction",
                                        ndepths=NUMDEPTH)
        argv += ["--listfile", str(listfile)]
    else:
        scale = 1.0
        j_ds = j_datasets.FacescapeMVSDataset(
            j_root, stage="val", ndepths=NUMDEPTH,
            **_fs_kwargs(tmp_path / "j_meta"))
        argv += ["--listfile", "unused", "--dataset", "facescape",
                 "--dataset-kwargs",
                 json.dumps(_fs_kwargs(tmp_path / "t_meta"))]
    depths = _jax_write(cascade, j_ds, scale)
    seconds = mvs_cli.main(argv)
    assert len(seconds) == len(j_ds) and len(depths) == len(j_ds) >= 4
    for dpath, (j_depth, t_depth, same, clear) in depths.items():
        assert same[clear].all() and clear.mean() > 0.9, dpath
        equal = j_depth == t_depth
        assert equal.mean() > 0.2, dpath     # a test of the bitwise claim
        stem = Path(dpath).relative_to(j_root).with_suffix("")
        for suffix in ("", "_conf", "_vis"):
            name = f"{stem}_TransMVSNet{suffix}.png"
            want = imageio.imread(j_root / name)
            got = codecs.read_png(t_root / name)
            assert got.dtype == want.dtype and got.shape == want.shape
            diff = np.abs(got.astype(int) - want.astype(int))
            if suffix == "":
                assert diff[equal].max() == 0, name
            assert diff[same if suffix else slice(None)].max() <= 1, name


def test_cli_eval_matches_jax(cascade, trees, tmp_path):
    """`mvs eval --device cpu` writes JAX's depth_est and confidence PFMs
    (the product of the three stages' confidences), cams and images."""
    out = tmp_path / "out"
    seconds = mvs_cli.main(
        ["eval", "--datapath", str(trees["eval"]), "--testlist", "scan9",
         "--outdir", str(out), "--num_view", "4", "--img_ext", ".png",
         "--device", "cpu", "--torch-ckpt",
         str(_ckpt(cascade, tmp_path / "m.ckpt"))] + CLI_ARCH)
    ds = j_datasets.GeneralEvalMVSDataset(trees["eval"], ["scan9"], nviews=4,
                                          ndepths=NUMDEPTH, img_ext=".png")
    assert len(seconds) == len(ds) == 4
    scan = out / "scan9"
    for i in range(len(ds)):
        s = ds[i]
        ref = int(s["view_ids"][0])
        o, _ = _run_jax(cascade, s["imgs"][None],
                        {k: v[None] for k, v in s["proj_matrices"].items()},
                        s["depth_values"][None])
        conf = o["photometric_confidence"]
        up = [np.asarray(jax.image.resize(
            o[st]["photometric_confidence"], conf.shape, "bilinear"))
            for st in ("stage1", "stage2")]
        want_conf = np.asarray(conf) * up[0] * up[1]
        depth, _ = j_codecs.read_pfm(scan / "depth_est" / f"{ref:08d}.pfm")
        got_conf, _ = j_codecs.read_pfm(scan / "confidence" / f"{ref:08d}.pfm")
        top2 = np.sort(o["stage3"]["prob_volume"][0], axis=0)[-2:]
        clear = top2[1] - top2[0] > 1e-5
        np.testing.assert_allclose(depth[clear], o["depth"][0][clear],
                                   rtol=1e-6)
        np.testing.assert_allclose(got_conf, want_conf[0], atol=1e-5)
        ext, K, (dmin, dint) = j_codecs.read_mvsnet_cam(
            scan / "cams" / f"{ref:08d}_cam.txt")
        proj = s["proj_matrices"]["stage3"][0]
        np.testing.assert_allclose(ext, proj[0], atol=1e-6)
        np.testing.assert_allclose(K, proj[1][:3, :3], atol=1e-5)
        dv = s["depth_values"]
        np.testing.assert_allclose([dmin, dint], [dv[0], dv[1] - dv[0]],
                                   rtol=1e-6)
        img = np.asarray(Image.open(scan / "images" / f"{ref:08d}.png"))
        np.testing.assert_array_equal(
            img, (np.clip(s["imgs"][0], 0, 1) * 255).astype(np.uint8))


def test_cli_runs_on_cuda_unless_told_otherwise(trees, monkeypatch, tmp_path):
    """Every subcommand defaults to the CUDA device and raises without
    one, with each of the options --compute-dtype, --dcn-impl and
    --data-parallel too (train with --multihost, fuse); a flag the port
    lacks is refused, not ignored; --ckpt with no checkpoint raises; train
    needs its data and log flags."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, listfile = trees["dtu"]
    with pytest.raises(RuntimeError, match="CUDA"):
        mvs_cli.main(["write", "--datapath", str(root), "--listfile",
                      str(listfile)] + CLI_ARCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        mvs_cli.main(["eval", "--datapath", str(trees["eval"]), "--testlist",
                      "scan9", "--outdir", str(tmp_path)] + CLI_ARCH)
    for flag in (["--compute-dtype", "bfloat16"], ["--dcn-impl", "window"],
                 ["--data-parallel"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            mvs_cli.main(["write", "--datapath", str(root), "--listfile",
                          str(listfile)] + CLI_ARCH + flag)
        with pytest.raises(RuntimeError, match="CUDA"):
            mvs_cli.main(["eval", "--datapath", str(trees["eval"]),
                          "--testlist", "scan9", "--outdir", str(tmp_path)]
                         + CLI_ARCH + flag)
    for flag in (["--compute-dtype", "bfloat16"], ["--dcn-impl", "window"],
                 ["--multihost"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            mvs_cli.main(["train", "--datapath", str(root), "--listfile",
                          str(listfile), "--logdir", str(tmp_path / "run")]
                         + CLI_ARCH + flag)
    with pytest.raises(RuntimeError, match="CUDA"):
        mvs_cli.main(["fuse", "--datapath", str(trees["eval"]), "--testlist",
                      "scan9", "--outdir", str(tmp_path)])
    with pytest.raises(SystemExit):
        mvs_cli.main(["write", "--datapath", str(root), "--listfile",
                      str(listfile), "--device", "cpu", "--shard-rays"])
    with pytest.raises(FileNotFoundError):
        mvs_cli.main(["write", "--datapath", str(root), "--listfile",
                      str(listfile), "--device", "cpu", "--ckpt",
                      str(tmp_path / "x")] + CLI_ARCH)
    with pytest.raises(SystemExit):
        mvs_cli.main(["train", "--datapath", str(root)])
