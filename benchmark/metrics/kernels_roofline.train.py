"""The training kernels' share (%) of their roofline in the traced window:
the sum of each launch's least time (metrics/kernel_counts.py, at the
step's shapes: batch x the patch's rays x the samples a ray) over the sum
of the launches' device time, for K4 (composite_rays) and its backward."""

from metrics import kernel_counts as kc


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    c = ctx["counts"]
    B = c["rays_per_step"]
    K = ctx["config"]["train"]["renderer"]["kwargs"]["n_samples"]
    return kc.roofline_pct(t, {kc.K4: kc.k4(B, K),
                               kc.K4_BWD: kc.k4_backward(B * K, B)})
