"""Reference DINER (PyTorch Lightning) checkpoints <-> the port's PixelNeRF
state_dict (counterpart of diner_tpu.nn.torch_port.load_torch_state_dict
and diner_tpu.models.torch_port.port_diner_checkpoint / export_diner).

A released checkpoint holds the PixelNeRF tree under reference names:
  nerf.encoder.model.*   the torchvision resnet34 trunk, conv1 widened by
                         the border-PE surgery (image_encoder.py:68-86)
  nerf.mlp_fine.*        ResnetFC: lin_in, lin_out, lin_z.N, blocks.N.fc_0/1
  nerf.poscode.*, nerf.depthcode.*, znear, zfar, vggloss.vgg_net.*
The map goes straight to the port's keys:
  conv1 -> encoder.trunk.conv1, bn1 -> encoder.trunk.norm1,
  layerS.B.{conv1, conv2, bn1, bn2, downsample.0, downsample.1} ->
  encoder.trunk.layerS_blockB.{conv_0, conv_1, norm_0, norm_1,
  downsample_conv, downsample_norm}, nerf.mlp_fine.* -> mlp.*.
Both sides keep torch's layouts (OIHW convs, (out, in) linears), so weights
are copied as they are. The trunk must be BatchNorm (encoder_norm="batch"),
as the reference's is. The posenc buffers are recomputed from num_freqs and
freq_factor; the frozen VGG of the perceptual loss is not carried (the port
has no training yet).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from diner_tpu_torch.nn.resnet import STAGE_BLOCKS

_ENC = "nerf.encoder.model."
_MLP = "nerf.mlp_fine."
_BN = ("weight", "bias", "running_mean", "running_var")
_BLOCK_PARTS = {"conv1": "conv_0", "conv2": "conv_1", "bn1": "norm_0",
                "bn2": "norm_1", "downsample.0": "downsample_conv",
                "downsample.1": "downsample_norm"}


def load_torch_state_dict(path) -> Dict[str, torch.Tensor]:
    """The state_dict of a .ckpt / .pth file, unwrapped from the Lightning
    {"state_dict": ...} layout, as CPU tensors. The file is unpickled in
    full (Lightning stores more than tensors): load only trusted files."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    sd = sd.get("state_dict", sd)
    return {k: torch.as_tensor(v).detach().cpu() for k, v in sd.items()}


def _trunk_keys(backbone: str, num_layers: int):
    """(reference key, port key) of every tensor of the port's trunk."""
    pairs = [("conv1.weight", "conv1.weight")]
    pairs += [(f"bn1.{leaf}", f"norm1.{leaf}") for leaf in _BN]
    for stage in range(min(num_layers - 1, 4)):
        for blk in range(STAGE_BLOCKS[backbone][stage]):
            ref = f"layer{stage + 1}.{blk}"
            port = f"layer{stage + 1}_block{blk}"
            for part, name in _BLOCK_PARTS.items():
                leaves = ("weight",) if "conv" in name else _BN
                pairs += [(f"{ref}.{part}.{leaf}", f"{port}.{name}.{leaf}")
                          for leaf in leaves]
    return pairs


def from_lightning(sd: Mapping, backbone: str = "resnet34",
                   num_layers: int = 4) -> Tuple[Dict[str, torch.Tensor],
                                                 Dict]:
    """Reference Lightning state_dict -> (the port's PixelNeRF state_dict,
    extras). extras: conv1_in_channels (3 + the border-PE channels the
    checkpoint was trained with), znear and zfar (None when absent)."""
    def f32(key):
        return torch.as_tensor(np.asarray(sd[key], np.float32))

    out = {}
    for ref, port in _trunk_keys(backbone, num_layers):
        if f"{_ENC}{ref}" in sd:
            out[f"encoder.trunk.{port}"] = f32(f"{_ENC}{ref}")
        elif "downsample" not in ref:
            raise KeyError(f"checkpoint lacks {_ENC}{ref}")
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key[: -len("running_mean")] + "num_batches_tracked"] = \
            torch.tensor(0)
    for key in sd:
        if key.startswith(_MLP):
            if ".shortcut." in key:
                raise KeyError(f"{key}: ResnetFC blocks with a shortcut are "
                               "not supported")
            out[f"mlp.{key[len(_MLP):]}"] = f32(key)
    extras = {"conv1_in_channels": int(sd[f"{_ENC}conv1.weight"].shape[1]),
              "znear": float(sd["znear"]) if "znear" in sd else None,
              "zfar": float(sd["zfar"]) if "zfar" in sd else None}
    return out, extras


def _posenc_buffers(prefix: str, num_freqs: int, freq_factor: float):
    """The reference PositionalEncoding's persistent buffers
    (positional_encoding.py:18-31): _freqs repeated twice per frequency and
    _phases (0, pi/2, 0, pi/2, ...), both (1, 2F, 1)."""
    freqs = freq_factor * 2.0 ** np.arange(num_freqs, dtype=np.float32)
    phases = np.zeros(2 * num_freqs, np.float32)
    phases[1::2] = np.pi * 0.5
    return {f"{prefix}._freqs": np.repeat(freqs, 2).reshape(1, -1, 1),
            f"{prefix}._phases": phases.reshape(1, -1, 1)}


def to_lightning(model) -> Dict[str, torch.Tensor]:
    """A DINER (its PixelNeRF, znear and zfar) -> a reference-keyed Lightning
    state_dict, the inverse of `from_lightning`. Save it as
    torch.save({"state_dict": sd}, path)."""
    nerf = model.nerf
    if not isinstance(nerf.encoder.trunk.norm1, torch.nn.BatchNorm2d):
        raise ValueError("the reference trunk is BatchNorm: export needs "
                         "encoder_norm='batch'")
    own = {k: v.detach().cpu() for k, v in nerf.state_dict().items()}
    sd = {"znear": torch.tensor(model.znear, dtype=torch.float32),
          "zfar": torch.tensor(model.zfar, dtype=torch.float32)}
    for name in ("nerf.poscode", "nerf.depthcode"):
        sd.update({k: torch.from_numpy(v) for k, v in _posenc_buffers(
            name, nerf.num_freqs, nerf.freq_factor).items()})
    trunk = nerf.encoder.trunk
    for ref, port in _trunk_keys(trunk.backbone, trunk.num_layers):
        if f"encoder.trunk.{port}" in own:
            sd[f"{_ENC}{ref}"] = own[f"encoder.trunk.{port}"]
            if ref.endswith("running_var"):
                sd[f"{_ENC}{ref[: -len('running_var')]}num_batches_tracked"] \
                    = torch.tensor(0)
    for key, value in own.items():
        if key.startswith("mlp."):
            sd[f"{_MLP}{key[len('mlp.'):]}"] = value
    return sd
