"""The training window's model FLOPs over its seconds, as a share (%) of
the H100's float32 peak outside the tensor cores (the recipe's GEMMs run
in float32): forward and backward (twice the forward) of ResnetFC for
every sample and of the encoder for every source view, and VGG19 to
relu4_1 on the loss patches (the prediction's and the target's forward
and the prediction's input gradient)."""

from metrics import flops


def read(ctx):
    c, cfg = ctx["counts"], ctx["config"]
    if not c.get("steps"):
        return None
    nerf = cfg["train"]["nerf"]
    field = c["samples"] * flops.field_flops_per_sample(cfg, nerf)
    encoder = c["views"] * flops.encoder_flops_per_view(cfg, nerf)
    s = c["patch"]
    vgg = c["patches"] * 2 * flops.vgg_macs(s, s)
    total = 3 * (field + encoder + vgg)
    return 100.0 * total / ctx["window_s"] / flops.PEAK_F32
