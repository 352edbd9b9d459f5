"""The yardstick's arithmetic: FLOP counts, the kernels' least times, the
device's busy time and idle share, on numbers worked out by hand."""

import importlib.util
from pathlib import Path

import pytest
import torch

from lib import trace
from metrics import flops, kernel_counts as kc

BENCH = Path(__file__).resolve().parents[1]


def reader(name):
    spec = importlib.util.spec_from_file_location(
        name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_resnetfc_flops_match_the_hand_count():
    # 4 x (55*512 + 3*512^2 + 3*2*512^2) + 2*2*512^2 + 512*4
    assert flops.resnetfc_macs(55, 512, 512, 5, 3, 4) == 10_600_448
    import json

    cfg = json.loads((BENCH / "configs" / "diner_dtu.json").read_text())
    assert flops.field_flops_per_sample(cfg, cfg["serve"]["nerf"]) == \
        2 * 10_600_448
    assert flops.field_flops_per_sample(cfg, cfg["train"]["nerf"]) == \
        2 * 10_600_448


def _conv_macs_by_hooks(module, x):
    total = []

    def hook(m, inp, out):
        total.append(out.shape[-2] * out.shape[-1] * m.out_channels
                     * m.in_channels * m.kernel_size[0] * m.kernel_size[1])

    hs = [m.register_forward_hook(hook) for m in module.modules()
          if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        module(x)
    for h in hs:
        h.remove()
    return sum(total)


@pytest.mark.parametrize("hw,padding", [((32, 40), 8), ((48, 64), 16)])
def test_encoder_flops_match_its_convolutions(hw, padding):
    from diner_tpu_torch.nn.spatial_encoder import SpatialEncoder

    enc = SpatialEncoder(norm="group", image_padding=padding, padding_pe=4)
    x = torch.rand(1, *hw, 3)
    assert flops.encoder_macs(*hw, padding, 4) == _conv_macs_by_hooks(enc, x)


def test_vgg_flops_match_its_convolutions():
    from diner_tpu_torch.nn.vgg import Vgg19Features

    vgg = Vgg19Features()
    assert flops.vgg_macs(64, 64) == _conv_macs_by_hooks(
        vgg, torch.rand(1, 64, 64, 3))


def test_kernel_bounds_match_chip_smoke():
    """chip_smoke.py's bounds at one chunk of the fast preset (G = 4 views x
    4096 rays, 1000 candidates, 256 anchors, 32 samples) and K4's backward
    at batch 4, 40 samples: 0.0737, 0.0063, 0.0008 and 0.0072 ms."""
    G = 4 * 4096
    assert round(kc.k1(G, 1000, 256) * 1e3, 4) == 0.0737
    assert round(kc.k2(G, 32, 256) * 1e3, 4) == 0.0063
    assert round(kc.k4(4096, 32) * 1e3, 4) == 0.0008
    assert round(kc.k4_backward(4 * 4096 * 40, 4 * 4096) * 1e3, 4) == 0.0072
    assert kc.k1(G, 1000, 256) == 4 * (3 * G * 1000 + 3 * G * 256 + G) \
        / 3.35e12


def test_roofline_share_over_the_trace():
    t = trace.Trace(kernels={
        "likelihood_kernel(int const*, float const*)": [200_000, 200_000],
        "composite_kernel(float const*)": [10_000],
        "composite_bwd_kernel(float const*)": [1],
        "sm80_xmma_gemm": [10 ** 9]})
    least = {kc.K1: 100e-6, kc.K4: 1e-6}
    # (2 x 100 + 1) us of least time over (400 + 10) us of device time
    assert reader("kernels_roofline.render")  # the reader loads
    assert kc.roofline_pct(t, least) == pytest.approx(100 * 201 / 410)
    assert t.launches(kc.K4) == (1, 10e-6)
    assert kc.roofline_pct(trace.Trace(), least) is None


def test_union_gaps_and_idle_share_on_made_up_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (22, 25), (40, 41)]
    assert trace.union_length(iv) == 15 + 10 + 1
    assert trace.gaps(iv) == [(15, 20), (30, 40)]
    host = [(0, 100, "outer"), (14, 21, "sync"), (31, 39, "loader")]
    assert trace.idle_by_host(trace.gaps(iv), host) == [
        ("loader", 10e-9), ("sync", 5e-9)]
    assert trace.idle_by_host([(50, 60)], [])[0][0] == "host idle"
    t = trace.Trace(busy_ns=int(0.75e9))
    for cell in ("render", "train"):
        assert reader(f"device.idle_share.{cell}")(
            {"trace": t, "window_s": 1.0}) == pytest.approx(25.0)
        assert reader(f"device.idle_share.{cell}")(
            {"trace": None, "window_s": 1.0}) is None


def test_mfu_readers_on_counted_work():
    import json

    cfg = json.loads((BENCH / "configs" / "diner_dtu.json").read_text())
    per = flops.field_flops_per_sample(cfg, cfg["serve"]["nerf"])
    enc = flops.encoder_flops_per_view(cfg, cfg["serve"]["nerf"])
    ctx = {"config": cfg, "window_s": 2.0,
           "counts": {"frames": 2, "loads": 1, "samples": 1000}}
    assert reader("render.mfu")(ctx) == pytest.approx(
        100 * (1000 * per + 4 * enc) / 2.0 / 989e12)
    ctx["counts"] = {"frames": 0}
    assert reader("render.mfu")(ctx) is None
    ctx["counts"] = {"steps": 1, "samples": 10, "views": 4, "patches": 4,
                     "patch": 64}
    assert reader("train.mfu")(ctx) == pytest.approx(
        100 * 3 * (10 * per + 4 * enc + 4 * 2 * flops.vgg_macs(64, 64))
        / 2.0 / 67e12)
