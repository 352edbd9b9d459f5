"""Weights of the MVS cascade: the JAX package's flax variables and the
reference TransMVSNet's torch checkpoints -> the port's state_dict.

The port's module tree carries the reference's names, so a reference
checkpoint ({"epoch", "model", "optimizer"}, a Lightning-style
{"state_dict": ...} or a bare state dict, keys with or without DDP's
"module." prefix) loads by its own keys (`load_reference_state_dict`), and
`to_reference_state_dict` gives the port's weights back in that layout.

`from_jax` maps `diner_tpu.mvs.TransMVSNet`'s {"params", "batch_stats"}:
- conv kernels HWIO -> OIHW and DHWIO -> OIDHW;
- the transposed 3D kernels (D, H, W, O, I) -> ConvTranspose3d's
  (I, O, D, H, W);
- Dense kernels (in, out) -> (out, in); LayerNorm and BatchNorm scale ->
  weight; batch stats mean/var -> running_mean/running_var;
- flax's auto-numbered modules onto the reference's names (CostRegNet's
  outer stride-1 conv is numbered before the strided one it wraps);
- the DCN offset channels: the JAX DCNLayer reads dy_k, dx_k from its
  offset conv's channels k and K*K + k, the port (as torchvision does
  cat(o1, o2)) from channels 2k and 2k + 1.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_TRUNK = ("conv0.0", "conv0.1", "conv1.0", "conv1.1", "conv1.2",
          "conv2.0", "conv2.1", "conv2.2")
# flax Conv3dBnRelu_j -> the reference CostRegNet's conv name
_COSTREG = ("conv0", "conv2", "conv1", "conv4", "conv3", "conv6", "conv5")
_HEAD = (("ConvBnRelu_0", "0", "convbn"), ("DCNLayer_0", "1", "dcn"),
         ("BatchNorm_0", "2", "bn"), ("DCNLayer_1", "4", "dcn"),
         ("BatchNorm_1", "5", "bn"), ("DCNLayer_2", "7", "dcn"))


def _modules(n_stages: int, n_fmt_layers: int):
    """(flax module path, port module name, kind) of every module that
    holds weights."""
    out = [(f"feature/ConvBnRelu_{i}", f"feature.{t}", "convbn")
           for i, t in enumerate(_TRUNK)]
    for head in ("out1", "out2", "out3"):
        out += [(f"feature/{head}/{f}", f"feature.{head}.{t}", kind)
                for f, t, kind in _HEAD]
    out += [(f"feature/{lat}", f"feature.{lat}", "conv")
            for lat in ("inner1", "inner2")]
    for i in range(n_stages):
        pre = f"cost_regularization.{i}"
        out += [(f"costreg_{i}/Conv3dBnRelu_{j}", f"{pre}.{t}", "convbn")
                for j, t in enumerate(_COSTREG)]
        out += [(f"costreg_{i}/Deconv3dBnRelu_{j}", f"{pre}.conv{7 + 2 * j}",
                 "deconvbn") for j in range(3)]
        out.append((f"costreg_{i}/Conv_0", f"{pre}.prob", "conv"))
    pw = "DepthNet.pixel_wise_net"
    out += [("pixel_wise_net/Conv3dBnRelu_0", f"{pw}.conv0", "convbn"),
            ("pixel_wise_net/Conv3dBnRelu_1", f"{pw}.conv1", "convbn"),
            ("pixel_wise_net/Conv_0", f"{pw}.conv2", "conv")]
    for i in range(n_fmt_layers):
        src = f"fmt_with_pathway/fmt/layer_{i}"
        dst = f"FMT_with_pathway.FMT.layers.{i}"
        out += [(f"{src}/attention/{p}", f"{dst}.attention.{p}", "dense")
                for p in ("query_projection", "key_projection",
                          "value_projection", "out_projection")]
        out += [(f"{src}/{p}", f"{dst}.{p}", "dense")
                for p in ("linear1", "linear2")]
        out += [(f"{src}/{p}", f"{dst}.{p}", "ln") for p in ("norm1", "norm2")]
    out += [(f"fmt_with_pathway/{p}", f"FMT_with_pathway.{p}", "conv")
            for p in ("dim_reduction_1", "dim_reduction_2", "smooth_1",
                      "smooth_2")]
    return out


def _kernel(k):
    """flax conv kernel (spatial..., I, O) -> torch (O, I, spatial...)."""
    k = np.asarray(k, np.float32)
    return k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2))


def _dcn_perm(taps: int = 9):
    """perm[j]: the JAX offset-conv channel that the port's channel j
    holds."""
    perm = np.empty(3 * taps, np.int64)
    perm[0:2 * taps:2] = np.arange(taps)
    perm[1:2 * taps:2] = taps + np.arange(taps)
    perm[2 * taps:] = 2 * taps + np.arange(taps)
    return perm


def _get(tree, path):
    for seg in path.split("/"):
        tree = tree[seg]
    return tree


def _bn(sd, name, p, s):
    sd[f"{name}.weight"] = p["scale"]
    sd[f"{name}.bias"] = p["bias"]
    sd[f"{name}.running_mean"] = s["mean"]
    sd[f"{name}.running_var"] = s["var"]


def from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax variables {"params", "batch_stats"} of the JAX TransMVSNet (as
    numpy or jax arrays) -> the port's TransMVSNet state_dict (float32)."""
    params, stats = variables["params"], variables["batch_stats"]
    n_stages = sum(k.startswith("costreg_") for k in params)
    n_fmt_layers = len(params["fmt_with_pathway"]["fmt"])
    sd = {}
    for src, dst, kind in _modules(n_stages, n_fmt_layers):
        p = _get(params, src)
        if kind == "conv":
            sd[f"{dst}.weight"] = _kernel(p["kernel"])
            if "bias" in p:
                sd[f"{dst}.bias"] = p["bias"]
        elif kind == "dense":
            sd[f"{dst}.weight"] = np.asarray(p["kernel"]).T
            sd[f"{dst}.bias"] = p["bias"]
        elif kind == "ln":
            sd[f"{dst}.weight"] = p["scale"]
            sd[f"{dst}.bias"] = p["bias"]
        elif kind == "dcn":
            om = p["conv_offset_mask"]
            perm = _dcn_perm(np.asarray(om["bias"]).shape[0] // 3)
            sd[f"{dst}.conv_offset_mask.weight"] = _kernel(om["kernel"])[perm]
            sd[f"{dst}.conv_offset_mask.bias"] = np.asarray(om["bias"])[perm]
            sd[f"{dst}.weight"] = _kernel(p["weight"])
            sd[f"{dst}.bias"] = p["bias"]
        elif kind == "bn":
            _bn(sd, dst, p, _get(stats, src))
        else:                                   # convbn, deconvbn
            s = _get(stats, src)
            if kind == "convbn":
                sd[f"{dst}.conv.weight"] = _kernel(p["Conv_0"]["kernel"])
            else:   # (D, H, W, O, I) -> (I, O, D, H, W)
                sd[f"{dst}.conv.weight"] = np.asarray(
                    p["ConvTranspose_0"]["kernel"]).transpose(4, 3, 0, 1, 2)
            _bn(sd, f"{dst}.bn", p["BatchNorm_0"], s["BatchNorm_0"])
    out = {k: torch.from_numpy(np.ascontiguousarray(np.asarray(v, np.float32)))
           for k, v in sd.items()}
    for key in [k for k in out if k.endswith(".running_mean")]:
        out[key[: -len("running_mean")] + "num_batches_tracked"] = \
            torch.tensor(0)
    return out


def load_reference_state_dict(net, source) -> None:
    """Load a reference TransMVSNet checkpoint (a path, or a state dict)
    into the port's `net`. Raises on a missing, unexpected or misshapen
    key; the BatchNorm step counters (num_batches_tracked, unused in
    inference) may be absent."""
    sd = source
    if not isinstance(sd, Mapping):
        sd = torch.load(sd, map_location="cpu", weights_only=False)
    for wrapper in ("state_dict", "model"):
        if isinstance(sd.get(wrapper), Mapping):
            sd = sd[wrapper]
            break
    sd = {(k[len("module."):] if k.startswith("module.") else k):
          torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
          for k, v in sd.items()}
    own = net.state_dict()
    missing = sorted(k for k in own if k not in sd
                     and not k.endswith("num_batches_tracked"))
    unexpected = sorted(k for k in sd if k not in own)
    misshapen = sorted(f"{k}: {tuple(sd[k].shape)} vs {tuple(own[k].shape)}"
                       for k in own if k in sd
                       and sd[k].shape != own[k].shape)
    if missing or unexpected or misshapen:
        raise KeyError("the checkpoint does not match the TransMVSNet "
                       f"architecture: missing {missing}, unexpected "
                       f"{unexpected}, misshapen {misshapen}")
    net.load_state_dict(sd, strict=False)


def to_reference_state_dict(net) -> Dict[str, torch.Tensor]:
    """The port's TransMVSNet (or its state_dict) -> the reference's state
    dict, the inverse of `load_reference_state_dict` and the counterpart of
    the JAX package's `export_transmvsnet`: bare keys (no DDP "module."
    prefix, the single-GPU load path of the reference's train.py:100-104)
    and no BatchNorm step counters, CPU tensors. Save it as
    torch.save({"epoch": step, "model": sd}, path)."""
    sd = net.state_dict() if isinstance(net, torch.nn.Module) else net
    return {k: v.detach().cpu().clone() for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}
