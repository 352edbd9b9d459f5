"""The MVS options of diner_tpu_torch (the window DCN and its offset audit,
bfloat16 compute, --data-parallel, the FaceScape and MultiFace training
adapters, checkpoints across DCN implementations) against diner_tpu on the
CPU.

The cascade is test_torch_mvs's: 4 views at 32x32, ndepths (8, 8, 8) over
32 hypotheses, base channels 4, JAX's variables drawn from numpy with DCN
offsets of up to about 2 px, so that some taps lie beyond the window's
exact domain. One jitted JAX forward serves each (dtype, DCN
implementation): (float32, window), which also returns the sown
"diagnostics", and (bfloat16, gather), compiled without XLA's excess
precision so that it rounds wherever flax's dtype rules say, and which
also returns each held block's input. Torch runs on one intra-op thread.

Tolerances:
- the window DCN op, float32: outputs and every gradient 1e-5 abs + 1e-5
  rel against JAX's, offsets inside and beyond the window (clamped, their
  gradient exactly 0 in both); against the port's gather form, |offset| <
  1, 1e-5 abs;
- `window_offset_stats`: each layer's largest |k + offset| within 1e-5;
- the window cascade: test_torch_mvs's per-stage tolerance;
- each bfloat16 block against the same flax block run op by op: bit for
  bit on at least 99.9% of its live entries, a bound the block run in
  float32 misses (`test_bf16_blocks_round_as_jax_bf16`);
- the bfloat16 cascade against JAX's bfloat16 cascade: each stage's
  confidence within 1e-2 on average, and everywhere within 1e-2 or twice
  the float32 cascade's largest distance from JAX's bfloat16 one,
  whichever is larger (measured when the test was written: stages 1, 2
  and 3 2.6e-4, 5.9e-3 and 2.3e-2 at most); its depth within a tenth of
  the stage's hypothesis interval on at least 99% of the pixels away from
  WTA near-ties (the two largest JAX probabilities more than 1e-3 apart,
  and the stage's hypotheses the same, which a near-tie of the previous
  stage can change; measured: 100%, 99.1% and 99.8%). The two cascades
  still round apart where their libraries order a sum differently (a
  convolution's, the softmax's), and the near-ties of random weights
  carry that far: at this fixture's widths JAX's own float32 and bfloat16
  cascades differ by up to 3.4e-2 in stage 3's confidence, so a bound of
  1e-2 on every stage-3 pixel cannot hold;
- --data-parallel over two CPU replicas: every written file bitwise equal
  to the sequential run's.
"""

import copy
import json
import shutil
import sys
from pathlib import Path

import flax.linen
import jax
import numpy as np
import pytest
import torch

from diner_tpu.cli import mvs as j_mvs_cli
from diner_tpu.mvs.net import TransMVSNet as JTransMVSNet
from diner_tpu.mvs.ops import deform_conv2d_window as j_deform_conv2d_window
from diner_tpu_torch.cli import mvs as mvs_cli
from diner_tpu_torch.mvs import (TransMVSNet, deform_conv2d,
                                 deform_conv2d_window, from_jax,
                                 window_offset_stats)
from diner_tpu_torch.mvs.checkpoint import _modules
from diner_tpu_torch.mvs.layers import DCNLayer
from diner_tpu_torch.mvs.ops import _blend, _blend_in_order
from diner_tpu_torch.train import ckpt_io

sys.path.insert(0, str(Path(__file__).parent))
from test_facescape import _make_fake_facescape  # noqa: E402
from test_multiface import _make_fake_multiface  # noqa: E402
from test_torch_mvs import (ARCH, CLI_ARCH, NV,  # noqa: E402
                            _assert_stage_matches, _cascade_inputs, _run_port,
                            _random_variables, _t, _write_dtu_mvs_tree)
from test_torch_mvs_train import (_write_dtu_train_tree)  # noqa: E402

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the window DCN op -----------------------------------------------------

def _dcn_case(spread, seed=0):
    rng = np.random.RandomState(seed)
    N, H, W, C, O, K = 2, 7, 9, 3, 4, 3
    x = rng.randn(N, H, W, C).astype(np.float32)
    offset = rng.uniform(-spread, spread,
                         (N, H, W, 2 * K * K)).astype(np.float32)
    mask = rng.rand(N, H, W, K * K).astype(np.float32)
    weight = rng.randn(K, K, C, O).astype(np.float32)
    bias = rng.randn(O).astype(np.float32)
    cot = rng.randn(N, H, W, O).astype(np.float32)
    return x, offset, mask, weight, bias, cot


def _port_args(x, offset, mask, weight, bias):
    """NHWC numpy -> the port's NCHW leaf tensors that require grad."""
    args = (_t(x).permute(0, 3, 1, 2), _t(offset).permute(0, 3, 1, 2),
            _t(mask).permute(0, 3, 1, 2), _t(weight).permute(3, 2, 0, 1),
            _t(bias))
    return [a.contiguous().requires_grad_(True) for a in args]


def test_window_dcn_matches_jax_with_gradients():
    """Offsets up to 2.5 px, so that some taps lie beyond the window's
    [-2, 2 - 1e-3]: JAX's clamp, the same output and the same gradients of
    <out, cot> with respect to every input; a clamped tap's offset gets a
    zero gradient in both."""
    x, offset, mask, weight, bias, cot = _dcn_case(2.5)

    def loss(*a):
        return (j_deform_conv2d_window(*a) * cot).sum()

    want = np.asarray(jax.jit(j_deform_conv2d_window)(x, offset, mask,
                                                      weight, bias))
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        x, offset, mask, weight, bias)
    args = _port_args(x, offset, mask, weight, bias)
    out = deform_conv2d_window(*args)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=1e-5)
    (out * _t(cot).permute(0, 3, 1, 2)).sum().backward()
    perms = [(0, 2, 3, 1)] * 3 + [(2, 3, 1, 0), (0,)]
    for name, a, perm, g in zip(("x", "offset", "mask", "weight", "bias"),
                                args, perms, grads):
        np.testing.assert_allclose(a.grad.permute(*perm).numpy(),
                                   np.asarray(g), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    # the taps clamped by the window: zero offset gradient in both packages
    K = 3
    k = np.arange(K * K)
    kyx = np.stack([k // K - 1, k % K - 1], -1).reshape(-1)
    disp = offset + kyx
    beyond = (disp < -2.0) | (disp > 2.0 - 1e-3)
    assert beyond.any()
    goff = args[1].grad.permute(0, 2, 3, 1).numpy()
    assert (goff[beyond] == 0).all() and (np.asarray(grads[1])[beyond] == 0
                                          ).all()


def test_window_dcn_equals_the_gather_form_inside_the_window():
    x, offset, mask, weight, bias, _ = _dcn_case(0.99, seed=1)
    args = [a.detach() for a in _port_args(x, offset, mask, weight, bias)]
    np.testing.assert_allclose(deform_conv2d_window(*args).numpy(),
                               deform_conv2d(*args).numpy(), atol=1e-5)


def test_blend_backward_is_its_products_gradient():
    """The bfloat16 corner blend's own backward (it keeps no product)
    against numerical derivatives, float64, for the rows and both
    in-cell weights, and its forward against the products it orders."""
    rng = np.random.RandomState(2)
    rows, wx, wy = (torch.from_numpy(a).requires_grad_(True) for a in (
        rng.randn(6, 4, 3), rng.rand(6, 1), rng.rand(6, 1)))
    assert torch.autograd.gradcheck(_blend, (rows, wx, wy))
    assert torch.equal(_blend(rows, wx, wy),
                       _blend_in_order(rows, wx, wy))


def test_dcn_layer_takes_two_impls_with_one_state_dict():
    with pytest.raises(ValueError, match="gather"):
        DCNLayer(4, 4, impl="stencil")
    a, b = DCNLayer(4, 4), DCNLayer(4, 4, impl="window")
    b.load_state_dict(a.state_dict())
    x = torch.randn(1, 4, 8, 8)
    torch.testing.assert_close(a(x), b(x), atol=1e-5, rtol=0)


# -- the cascade with the window DCN and the audit ------------------------

@pytest.fixture(scope="module")
def window_case():
    """(JAX's outputs and per-layer diagnostics, JAX's variables, the port's
    window net with the same weights, the inputs)."""
    net = JTransMVSNet(**ARCH, dcn_impl="window")
    inputs = _cascade_inputs(NV)
    variables = _random_variables(net, inputs)

    @jax.jit
    def apply(variables, imgs, projs, dv):
        out, state = net.apply(variables, imgs, projs, dv,
                               mutable=["diagnostics"])
        return out, state["diagnostics"]

    out, diag = jax.device_get(apply(variables, *inputs))
    per_layer = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(diag)[0]:
        keys = [p.key for p in path if p.key != "window_disp_max"]
        per_layer["/".join(keys)] = float(np.max(leaf))
    port = TransMVSNet(**ARCH, dcn_impl="window").eval()
    port.load_state_dict(from_jax(variables))
    return out, per_layer, variables, port, inputs


def _port_inputs(imgs, projs, dv):
    return (_t(imgs).permute(0, 1, 4, 2, 3),
            {k: _t(v) for k, v in projs.items()}, _t(dv))


def test_window_offset_stats_match_jax_layer_by_layer(window_case):
    """The port's DCN layer feature.out<h>.<1, 4, 7> is JAX's
    feature/out<h>/DCNLayer_<0, 1, 2>; the audit leaves the net in the
    mode it found it and records nothing after."""
    _, want, _, port, inputs = window_case
    max_disp, got = window_offset_stats(port, *_port_inputs(*inputs))
    names = {f"feature.out{h}.{m}": f"feature/out{h}/DCNLayer_{j}"
             for h in (1, 2, 3) for j, m in enumerate((1, 4, 7))}
    assert set(got) == set(names) and set(want) == set(names.values())
    for name, jname in names.items():
        np.testing.assert_allclose(got[name], want[jname], atol=1e-5,
                                   err_msg=name)
    assert max_disp == max(got.values()) > 2.0
    assert not port.training
    assert all(not m.record_disp and m.window_disp_max is None
               for m in port.modules() if isinstance(m, DCNLayer))


def test_window_cascade_matches_jax(window_case):
    want, _, _, port, inputs = window_case
    got = _run_port(port, *inputs)
    for st in ("stage1", "stage2", "stage3"):
        _assert_stage_matches(got[st], want[st], st)


def _sample(inputs):
    imgs, projs, dv = inputs
    return {"imgs": imgs[0], "proj_matrices": {k: v[0] for k, v in
                                               projs.items()},
            "depth_values": dv[0]}


@pytest.mark.parametrize("mode,planted", [("warn", True), ("fallback", True),
                                          ("off", True), ("warn", False)])
def test_window_check_prints_jax_words(window_case, mode, planted, capsys,
                                       monkeypatch):
    """_check_window_dcn's three modes, on the planted offsets (beyond the
    window) and on zero offsets (|k| <= 1 only): the port prints exactly
    JAX's lines; fallback returns the gather net with the same weights."""
    import diner_tpu.mvs as j_mvs

    _, want, variables, port, inputs = window_case
    if not planted:
        port = TransMVSNet(**ARCH, dcn_impl="window").eval()
        sd = port.state_dict()
        for k in sd:
            if "conv_offset_mask" in k:
                sd[k].zero_()
        port.load_state_dict(sd)
        want = {k: 1.0 for k in want}
    monkeypatch.setattr(j_mvs, "window_offset_stats",
                        lambda *a: (max(want.values()), want))
    args = mvs_cli.parser().parse_args(
        ["write", "--datapath", "x", "--listfile", "y", "--dcn-impl",
         "window", "--dcn-window-check", mode, *CLI_ARCH, *CPU])
    j_net = j_mvs_cli._check_window_dcn(
        JTransMVSNet(**ARCH, dcn_impl="window"), variables, None, None,
        None, args)
    jax_words = capsys.readouterr().out
    net = mvs_cli.check_window_dcn(port, [_sample(inputs)], args,
                                   torch.device("cpu"))
    assert capsys.readouterr().out == jax_words
    assert net.dcn_impl == j_net.dcn_impl
    if mode == "fallback":
        assert net is not port and not net.training
        assert all(m.impl == "gather" for m in net.modules()
                   if isinstance(m, DCNLayer))
        for k, v in port.state_dict().items():
            assert torch.equal(net.state_dict()[k], v), k
    else:
        assert net is port
    assert (jax_words == "") == (mode == "off")


# -- bfloat16 --------------------------------------------------------------

# the blocks held one by one, by flax path: FeatureNet's trunk, the first
# head's DCN layers (with either implementation) and the head, the first
# two FMT layers (a self layer on the float32 sum with the position
# encoding, a cross layer), the first cost-regularization UNet's blocks and
# the UNet, and PixelwiseNet
BF16_BLOCKS = {
    "conv2d": [f"feature/ConvBnRelu_{i}" for i in range(8)],
    "dcn_gather": [f"feature/out1/DCNLayer_{i}" for i in range(3)],
    "dcn_window": [f"feature/out1/DCNLayer_{i}" for i in range(3)],
    "dcn_head": ["feature/out1"],
    "encoder": [f"fmt_with_pathway/fmt/layer_{i}" for i in (0, 1)],
    "conv3d": ([f"costreg_0/Conv3dBnRelu_{i}" for i in range(7)]
               + [f"costreg_0/Deconv3dBnRelu_{i}" for i in range(3)]),
    "costreg": ["costreg_0"],
    "pixelwise": ["pixel_wise_net"],
}


def _port_block_names():
    names = {src: dst for src, dst, _ in _modules(3, 8)}
    names.update({f"feature/out{h}": f"feature.out{h}" for h in (1, 2, 3)})
    names.update({f"fmt_with_pathway/fmt/layer_{i}":
                  f"FMT_with_pathway.FMT.layers.{i}" for i in range(8)})
    names.update({f"costreg_{i}": f"cost_regularization.{i}"
                  for i in range(3)})
    names["pixel_wise_net"] = "DepthNet.pixel_wise_net"
    return names


@pytest.fixture(scope="module")
def bf16_case():
    """(JAX's bfloat16 outputs, compiled without excess precision, the
    port's bfloat16 net with the same weights, the inputs, and each
    block's first call in that cascade: {flax path: (the unbound flax
    module, its array inputs, its flag arguments, its variables)})."""
    net = JTransMVSNet(**ARCH, compute_dtype="bfloat16")
    inputs = _cascade_inputs(NV)
    variables = _random_variables(net, inputs)
    modules = {}

    @jax.jit
    def apply(variables, imgs, projs, dv):
        seen = {}

        def record(call, args, kwargs, context):
            mod = context.module
            key = "/".join(mod.path)
            if (context.method_name == "__call__" and key not in seen
                    and any(key in keys for keys in BF16_BLOCKS.values())):
                modules[key] = (mod.clone(parent=None),
                                [a for a in args if isinstance(a, bool)])
                seen[key] = [a for a in args if not isinstance(a, bool)]
            return call(*args, **kwargs)

        with flax.linen.intercept_methods(record):
            return net.apply(variables, imgs, projs, dv), seen

    # every rounding flax's dtype rules write down: XLA may otherwise keep
    # float32 between fused bfloat16 ops
    strict = apply.lower(variables, *inputs).compile(
        compiler_options={"xla_allow_excess_precision": False})
    out, seen = jax.device_get(strict(variables, *inputs))
    blocks = {}
    for key, (mod, flags) in modules.items():
        sub = {}
        for col in ("params", "batch_stats"):
            tree = variables[col]
            for part in key.split("/"):
                tree = tree.get(part, {})
            if tree:
                sub[col] = tree
        blocks[key] = (mod, seen[key], flags, sub)
    port = TransMVSNet(**ARCH, compute_dtype="bfloat16").eval()
    port.load_state_dict(from_jax(variables))
    return out, port, inputs, blocks


def _to_port(a, dtype):
    """A JAX array (channels last) -> the port's layout, bfloat16 where it
    was bfloat16 and `dtype` is, else float32."""
    bf16 = dtype == torch.bfloat16 and np.asarray(a).dtype != np.float32
    t = torch.from_numpy(np.array(a, np.float32)).to(
        torch.bfloat16 if bf16 else torch.float32)
    if t.dim() >= 4:
        t = t.movedim(-1, 1)
    return t.contiguous()


@pytest.mark.parametrize("kind", list(BF16_BLOCKS))
def test_bf16_blocks_round_as_jax_bf16(bf16_case, kind):
    """Each bfloat16 block of the port, on the input JAX's bfloat16
    cascade gave that block, against the same flax block run op by op
    (jax.disable_jit: XLA's fusion under jit may keep float32 between ops,
    so the jitted cascade skips roundings that flax's dtype rules write
    down): its output is bfloat16 and equal, bit for bit, on at least
    99.9% of the entries that either side makes nonzero (measured when
    the test was written: 99.91% at worst, every other block 100%). The
    same block run in float32 and rounded to bfloat16 at its end, which is
    what a block left in float32 gives, falls below that (85.5% at best),
    as do the blocks with a rounding point moved."""
    _, port, _, blocks = bf16_case
    f32 = TransMVSNet(**ARCH).eval()
    f32.load_state_dict(port.state_dict())
    names = _port_block_names()
    for key in BF16_BLOCKS[kind]:
        mod, args, flags, sub = blocks[key]
        ours, theirs = port.get_submodule(names[key]), f32.get_submodule(
            names[key])
        if kind == "dcn_window":
            mod = mod.clone(impl="window")
            ours, theirs = copy.deepcopy(ours), copy.deepcopy(theirs)
            ours.impl = theirs.impl = "window"
        with jax.disable_jit():
            want = np.asarray(mod.apply(sub, *args, *flags), np.float32)
        shares = []
        for block, dtype in ((ours, torch.bfloat16), (theirs, torch.float32)):
            with torch.no_grad():
                got = block(*[_to_port(a, dtype) for a in args])
            if dtype == torch.bfloat16:
                assert got.dtype == torch.bfloat16, key
            got = got.to(torch.bfloat16).float()
            if got.dim() >= 4:
                got = got.movedim(1, -1)
            got = got.reshape(want.shape).numpy()
            live = (got != 0) | (want != 0)
            shares.append(float(np.mean(got[live] == want[live])))
        assert shares[0] >= 0.999 > shares[1], (key, shares)


def test_bf16_cascade_matches_jax_bf16(bf16_case):
    """Parameters stay float32 and each stage's probability volume is
    float32; the bfloat16 cascade is held to JAX's bfloat16 cascade at the
    module docstring's tolerance, and no further from it than the float32
    cascade is (the reference's own bfloat16 rounding)."""
    want, port, inputs, _ = bf16_case
    assert all(p.dtype == torch.float32 for p in port.parameters())
    got = _run_port(port, *inputs)
    f32 = TransMVSNet(**ARCH).eval()
    f32.load_state_dict(port.state_dict())
    ref = _run_port(f32, *inputs)
    for st in ("stage1", "stage2", "stage3"):
        g, w, r = got[st], want[st], ref[st]
        assert g["prob_volume"].dtype == torch.float32
        wc = np.asarray(w["photometric_confidence"])
        dc = np.abs(g["photometric_confidence"].numpy() - wc)
        dc_ref = np.abs(r["photometric_confidence"].numpy() - wc)
        assert dc.mean() <= 1e-2, (st, dc.mean())
        assert dc.max() <= max(1e-2, 2 * dc_ref.max()), (st, dc.max())
        assert not torch.equal(g["photometric_confidence"],
                               r["photometric_confidence"])
        dv = np.asarray(w["depth_values"])
        interval = np.abs(np.diff(dv, axis=1)).mean(axis=1)     # (B, h, w)
        same = (np.abs(g["depth_values"].numpy() - dv)
                <= 0.1 * interval[:, None]).all(axis=1)
        top2 = np.sort(np.asarray(w["prob_volume"]), axis=1)[:, -2:]
        clear = same & (top2[:, 1] - top2[:, 0] > 1e-3)
        assert clear.mean() > 0.7, (st, clear.mean())
        close = (np.abs(g["depth"].numpy() - np.asarray(w["depth"]))
                 <= 0.1 * interval)
        assert close[clear].mean() >= 0.99, (st, close[clear].mean())


# -- the CLIs --------------------------------------------------------------

@pytest.fixture(scope="module")
def dtu(tmp_path_factory):
    root = tmp_path_factory.mktemp("dtu")
    return root, _write_dtu_mvs_tree(root)


def _written(tree):
    return {p.relative_to(tree): p.read_bytes()
            for p in sorted(tree.rglob("*_TransMVSNet*.png"))}


def test_data_parallel_over_two_replicas_writes_the_same_files(
        dtu, tmp_path, monkeypatch):
    """write --data-parallel over two CPU replicas, and over three (its
    last group padded), against the sequential run: the same files, byte
    for byte, in the dataset's order."""
    root, listfile = dtu
    trees = {"seq": tmp_path / "seq"}
    shutil.copytree(root, trees["seq"])
    base = ["--numdepth", "32", *CLI_ARCH, *CPU]
    order = {}
    real = mvs_cli.run_samples

    def spy(net, ds, idxs, fn, devices):
        seen = order.setdefault(len(devices), [])
        for s, out in real(net, ds, idxs, fn, devices):
            seen.append(Path(s["dpath"]).name)
            yield s, out

    monkeypatch.setattr(mvs_cli, "run_samples", spy)
    seq = mvs_cli.main(["write", "--datapath", str(trees["seq"]),
                        "--listfile", str(listfile), *base])
    want = _written(trees["seq"])
    assert len(want) == 3 * len(seq) == 12
    # 4 samples: two groups on two replicas; a padded group on three
    for n in (2, 3):
        devices = [torch.device("cpu")] * n
        monkeypatch.setattr(mvs_cli, "local_devices",
                            lambda args, dev, d=devices: d)
        tree = tmp_path / f"dp{n}"
        shutil.copytree(root, tree)
        dp = mvs_cli.main(["write", "--datapath", str(tree), "--listfile",
                           str(listfile), "--data-parallel", *base])
        assert len(dp) == len(seq) and order[n] == order[1]
        assert _written(tree) == want


def test_checkpoints_run_across_dcn_impls(tmp_path):
    """A checkpoint trained with --dcn-impl gather writes priors with
    --dcn-impl window, and one trained with window writes them with
    gather; the weights load as they were saved."""
    root = tmp_path / "dtu_train"
    root.mkdir()
    listfile = _write_dtu_train_tree(root)
    (root / "val.txt").write_text("scan1\n")
    for train_impl, write_impl in (("gather", "window"), ("window", "gather")):
        logdir = tmp_path / f"run_{train_impl}"
        recs = mvs_cli.main(["train", "--datapath", str(root), "--listfile",
                             str(listfile), "--logdir", str(logdir),
                             "--numdepth", "32", "--max-steps", "1",
                             "--dcn-impl", train_impl,
                             "--dcn-window-check", "off", *CLI_ARCH, *CPU])
        assert np.isfinite(recs[0]["loss"])
        args = mvs_cli.parser().parse_args(
            ["write", "--datapath", str(root), "--listfile",
             str(root / "val.txt"), "--numdepth", "32", "--ckpt",
             str(logdir / "ckpts"), "--dcn-impl", write_impl, *CLI_ARCH,
             *CPU])
        net = mvs_cli.build_net(args, torch.device("cpu"))
        assert all(m.impl == write_impl for m in net.modules()
                   if isinstance(m, DCNLayer))
        saved = ckpt_io.restore_latest(logdir / "ckpts")[0]["model"]
        for k, v in net.state_dict().items():
            assert torch.equal(v, saved[k]), k
        tree = tmp_path / f"write_{write_impl}"
        shutil.copytree(root, tree)
        seconds = mvs_cli.main(["write", "--datapath", str(tree),
                                "--listfile", str(tree / "val.txt"),
                                "--numdepth", "32", "--ckpt",
                                str(logdir / "ckpts"), "--dcn-impl",
                                write_impl, *CLI_ARCH, *CPU])
        assert len(seconds) == 4
        assert len(list((tree / "Depths/scan1").glob(
            "*_TransMVSNet.png"))) == 4


@pytest.mark.parametrize("name", ["facescape", "multiface"])
def test_cli_train_on_face_datasets(name, tmp_path):
    """train --dataset facescape and --dataset multiface, two steps each on
    the JAX tests' fake trees: finite losses, a checkpoint at step 2."""
    if name == "facescape":
        root = tmp_path / "fs"
        _make_fake_facescape(root)
        kwargs = {"meta_dir": str(tmp_path / "meta"), "val_subjects": [],
                  "slide_range": 0}
    else:
        root, cfg = _make_fake_multiface(tmp_path / "mf", tmp_path / "mf_meta")
        # the fake tree's split config trains on nothing: train on its val
        split = json.loads(Path(cfg).read_text())
        split["train"] = split["val"]
        cfg = tmp_path / "split.json"
        cfg.write_text(json.dumps(split))
        kwargs = {"split_config": str(cfg), "meta_dir": str(tmp_path / "meta"),
                  "downsample": 4}
    logdir = tmp_path / "run"
    recs = mvs_cli.main(["train", "--datapath", str(root), "--listfile",
                         "unused", "--dataset", name, "--dataset-kwargs",
                         json.dumps(kwargs), "--logdir", str(logdir),
                         "--numdepth", "32", "--max-steps", "2", *CLI_ARCH,
                         *CPU])
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert ckpt_io.all_steps(logdir / "ckpts") == [2]
