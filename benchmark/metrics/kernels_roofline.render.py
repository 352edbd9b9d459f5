"""The render kernels' share (%) of their roofline in the traced window:
the sum of each launch's least time (metrics/kernel_counts.py, at the
chunk's shapes) over the sum of the launches' device time, for K1
(likelihood_from_anchors), K2 (remap_anchors) and K4 (composite_rays)."""

from metrics import kernel_counts as kc


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    r = ctx["config"]["serve"]["renderer"]["kwargs"]
    NV, NR = ctx["config"]["n_views"], r["eval_chunk_rays"]
    G = NV * NR
    return kc.roofline_pct(t, {
        kc.K1: kc.k1(G, r["n_depth_candidates"], r["n_prior_anchors"]),
        kc.K2: kc.k2(G, r["n_samples"], r["n_prior_anchors"]),
        kc.K4: kc.k4(NR, r["n_samples"])})
