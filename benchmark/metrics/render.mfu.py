"""The render window's model FLOPs over its seconds, as a share (%) of the
H100's dense bfloat16 peak: ResnetFC's per sample at the configuration's
widths for every sample rendered, and the encoder's once a load_scene for
each source view."""

from metrics import flops


def read(ctx):
    c, cfg = ctx["counts"], ctx["config"]
    if not c.get("frames"):
        return None
    nerf = cfg["serve"]["nerf"]
    total = (c["samples"] * flops.field_flops_per_sample(cfg, nerf)
             + c["loads"] * cfg["n_views"]
             * flops.encoder_flops_per_view(cfg, nerf))
    return 100.0 * total / ctx["window_s"] / flops.PEAK_BF16
