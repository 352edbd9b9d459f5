"""LPIPS with the VGG16 tower (port of diner_tpu.nn.lpips).

Behavioral reference: pip lpips==0.1.4 `LPIPS(net="vgg")` as used by
src/evaluation/eval_suite.py:52,75-77 in malteprinzler/diner: a VGG16
feature tower tapped after relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3,
inputs in [-1, 1] shifted and scaled by fixed constants, each tap's
features unit-normalized per pixel (epsilon 1e-10 under the root, as the
JAX package does), squared differences weighted by the non-negative "lin"
heads and summed over channels, averaged over the pixels and summed over
the taps.

No weights ship with the repo. They come from the user's files, in either
of two layouts:
- `load_lpips_npz`: the .npz that scripts/port_lpips.py (the JAX package's
  `save_lpips_npz`) writes: flax's keys, HWIO kernels;
- `from_state_dicts`: pip lpips==0.1.4's `weights/v0.1/vgg.pth` (the lin
  heads) and torchvision's `vgg16` features, read as they are.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# lpips.ScalingLayer: shift and scale of the [-1, 1] inputs
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
VGG16_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
LIN_CH = (64, 128, 256, 512, 512)
# torchvision vgg16.features index of each convolution, stage by stage
VGG16_FEATURE_INDEX = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21),
                       (24, 26, 28))


def _conv_names():
    for si, (_, reps) in enumerate(VGG16_STAGES):
        for ci in range(reps):
            yield si, f"conv{si + 1}_{ci + 1}"


class Vgg16Tower(nn.Module):
    """VGG16's convolutions (conv1_1 .. conv5_3) on NCHW input; returns the
    relu outputs at the end of each stage."""

    def __init__(self):
        super().__init__()
        c_in = 3
        for si, name in _conv_names():
            ch = VGG16_STAGES[si][0]
            self.add_module(name, nn.Conv2d(c_in, ch, 3, padding=1))
            c_in = ch

    def forward(self, x):
        outs = []
        stage = 0
        for si, name in _conv_names():
            if si != stage:
                outs.append(x)
                x = F.max_pool2d(x, 2)
                stage = si
            x = F.relu(getattr(self, name)(x))
        outs.append(x)
        return outs


class LpipsVgg(nn.Module):
    """forward(x, y): NHWC images in [-1, 1] -> (B,) LPIPS distances."""

    def __init__(self):
        super().__init__()
        self.net = Vgg16Tower()
        for i, ch in enumerate(LIN_CH):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(ch)))
        self.register_buffer("shift", torch.tensor(SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x, y):
        fx = self.net((x.permute(0, 3, 1, 2) - self.shift) / self.scale)
        fy = self.net((y.permute(0, 3, 1, 2) - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a / torch.sqrt((a * a).sum(1, keepdim=True) + 1e-10)
            b = b / torch.sqrt((b * b).sum(1, keepdim=True) + 1e-10)
            w = getattr(self, f"lin{i}").abs()[None, :, None, None]
            total = total + ((a - b) ** 2 * w).sum(1).mean(dim=(1, 2))
        return total


def load_lpips_npz(path) -> Dict[str, torch.Tensor]:
    """LpipsVgg's state_dict from an .npz of flax's layout
    ("params/net/conv1_1/kernel" HWIO, "params/net/conv1_1/bias",
    "params/lin0", ...; other entries, such as the source files' sha256,
    are ignored)."""
    sd = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            if parts[0] != "params":
                continue
            v = torch.from_numpy(np.array(data[key], np.float32))
            if parts[1] == "net":
                if parts[3] == "kernel":
                    sd[f"net.{parts[2]}.weight"] = v.permute(3, 2, 0, 1)
                else:
                    sd[f"net.{parts[2]}.{parts[3]}"] = v
            else:
                sd[parts[1]] = v.reshape(-1)
    return {k: v.contiguous() for k, v in sd.items()}


def from_state_dicts(lpips_sd, vgg16_sd) -> Dict[str, torch.Tensor]:
    """LpipsVgg's state_dict from pip lpips's lin heads ("lin{i}.model.1.
    weight", or "lins.{i}.model.1.weight" in later releases) and
    torchvision vgg16's "features.{idx}.weight/bias" (OIHW, as torch
    keeps them)."""
    sd = {}
    names = [name for _, name in _conv_names()]
    idxs = [i for stage in VGG16_FEATURE_INDEX for i in stage]
    for name, idx in zip(names, idxs):
        for leaf in ("weight", "bias"):
            sd[f"net.{name}.{leaf}"] = torch.as_tensor(
                np.asarray(vgg16_sd[f"features.{idx}.{leaf}"]),
                dtype=torch.float32)
    for i in range(len(LIN_CH)):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in lpips_sd:
                sd[f"lin{i}"] = torch.as_tensor(
                    np.asarray(lpips_sd[key]), dtype=torch.float32
                ).reshape(-1)
                break
        else:
            raise KeyError(f"lin head {i} is not in the lpips state_dict")
    return sd


def make_lpips_fn(weights: Dict[str, torch.Tensor], device="cuda"):
    """(pred (H, W, 3) in [0, 1], gt) -> float LPIPS on `device` (CUDA
    unless the caller asks for "cpu"), the reference's usage
    (eval_suite.py:75-77: images scaled to [-1, 1]). weights: LpipsVgg's
    state_dict (`load_lpips_npz` or `from_state_dicts`). cuDNN's TF32 is
    off inside each call, so that the card scores as the CPU does."""
    from diner_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    model = LpipsVgg()
    model.load_state_dict(weights)
    model.to(dev).eval()

    def dist(pred, gt) -> float:
        x, y = (torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                device=dev)[None] * 2.0 - 1.0
                for a in (pred, gt))
        with torch.inference_mode(), torch.backends.cudnn.flags(
                enabled=True, allow_tf32=False):
            return float(model(x, y)[0])

    return dist
