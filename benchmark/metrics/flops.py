"""Model FLOPs counted from a configuration's widths (multiply-adds x 2).

ResnetFC per sample at NV views: NV x (d_in d_hidden + n_z d_latent d_hidden
+ 2 combine_layer d_hidden^2) before the view mean, 2 (n_blocks -
combine_layer) d_hidden^2 after it, and d_hidden d_out for the head, with
n_z = min(combine_layer, n_blocks) latent projections. At DINER's widths
(d_in 55, d_latent 512, d_hidden 512, 5 blocks, combine_layer 3, 4 views)
that is 10,600,448 multiply-adds. The encoder's convolutions (a ResNet34
trunk to its third stage, on the image padded by image_padding, with the
border positional encoding's channels) and VGG19's to relu4_1 are counted
from their layer shapes; pooling, norms and activations are not counted.
"""

from __future__ import annotations

PEAK_BF16 = 989e12     # H100 SXM dense bfloat16, FLOP/s
PEAK_F32 = 67e12       # H100 SXM float32 outside the tensor cores, FLOP/s

RESNET34_BLOCKS = (3, 4, 6, 3)
RESNET_CHANNELS = (64, 128, 256, 512)
VGG19_TO_RELU4_1 = (("conv", 3, 64), ("conv", 64, 64), ("pool",),
                    ("conv", 64, 128), ("conv", 128, 128), ("pool",),
                    ("conv", 128, 256), ("conv", 256, 256),
                    ("conv", 256, 256), ("conv", 256, 256), ("pool",),
                    ("conv", 256, 512))


def posenc_dim(d: int, num_freqs: int) -> int:
    return d + 2 * d * num_freqs


def resnetfc_macs(d_in: int, d_latent: int, d_hidden: int, n_blocks: int,
                  combine_layer: int, n_views: int, d_out: int = 4) -> int:
    n_z = min(combine_layer, n_blocks)
    before = min(combine_layer, n_blocks)
    per_view = (d_in * d_hidden + n_z * d_latent * d_hidden
                + before * 2 * d_hidden ** 2)
    after = (n_blocks - before) * 2 * d_hidden ** 2
    return n_views * per_view + after + d_hidden * d_out


def _out(n: int, k: int, stride: int) -> int:
    return (n + 2 * (k // 2) - k) // stride + 1


def encoder_macs(H: int, W: int, image_padding: int, padding_pe: int,
                 num_layers: int = 4) -> int:
    """One image through the trunk: conv1 (7x7, stride 2) and the first
    num_layers - 1 stages of BasicBlocks (the stem's max pool before the
    first)."""
    h, w = H + 2 * image_padding, W + 2 * image_padding
    c = 3 + (posenc_dim(2, padding_pe) if image_padding > 0
             and padding_pe >= 0 else 0)
    h, w = _out(h, 7, 2), _out(w, 7, 2)
    macs = h * w * 64 * c * 49
    c = 64
    h, w = _out(h, 3, 2), _out(w, 3, 2)               # max pool
    for stage in range(min(num_layers - 1, 4)):
        ch = RESNET_CHANNELS[stage]
        for blk in range(RESNET34_BLOCKS[stage]):
            stride = 2 if (stage > 0 and blk == 0) else 1
            ho, wo = _out(h, 3, stride), _out(w, 3, stride)
            macs += ho * wo * ch * c * 9 + ho * wo * ch * ch * 9
            if stride != 1 or c != ch:
                macs += ho * wo * ch * c
            h, w, c = ho, wo, ch
    return macs


def vgg_macs(H: int, W: int) -> int:
    """One image through VGG19 to relu4_1 (3x3 convs, 2x2 pools)."""
    macs, h, w = 0, H, W
    for layer in VGG19_TO_RELU4_1:
        if layer[0] == "pool":
            h, w = h // 2, w // 2
        else:
            macs += h * w * layer[1] * layer[2] * 9
    return macs


def field_flops_per_sample(config: dict, nerf: dict) -> int:
    """2 x ResnetFC's multiply-adds per sample for a `nerf` section."""
    kw = nerf["kwargs"]
    pos = kw["poscode_conf"]["kwargs"]
    mlp = kw["mlp_fine_conf"]["kwargs"]
    d_in = posenc_dim(3, pos["num_freqs"]) + posenc_dim(1, pos["num_freqs"]) + 3
    return 2 * resnetfc_macs(d_in, config["d_latent"], mlp["d_hidden"],
                             mlp["n_blocks"], mlp["combine_layer"],
                             config["n_views"])


def encoder_flops_per_view(config: dict, nerf: dict) -> int:
    enc = nerf["kwargs"]["encoder_conf"]["kwargs"]
    H, W = config["image_hw"]
    return 2 * encoder_macs(H, W, enc["image_padding"], enc["padding_pe"],
                            enc.get("num_layers", 4))
