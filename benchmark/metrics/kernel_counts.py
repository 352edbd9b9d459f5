"""Each kernel launch's least time on the H100, from the bytes it must move
and the operations it must do at its shapes: the larger of bytes over the
HBM's 3.35 TB/s and operations over 67 TFLOP/s (float32 outside the tensor
cores). A frozen copy of chip_smoke.py's `bound` and of its per-kernel
counts (each input byte read once, each output byte written once)."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
K1_OPS_PER_CANDIDATE = 56       # gates, scale, two erff, the bin mass
K4_OPS_PER_SAMPLE = 25          # delta, alpha with one expf, scan, sums
K4_BWD_OPS_PER_SAMPLE = 45      # the forward's terms and both scans

# the kernels' names in a device trace
K1, K2, K4, K4_BWD = ("likelihood_kernel", "remap_kernel",
                      "composite_kernel", "composite_bwd_kernel")


def least_s(n_bytes: float, n_ops: float = 0.0) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def k1(G: int, NC: int, A: int) -> float:
    """likelihood_from_anchors: ids, depths and p (G x NC), the anchor
    table (G x 3 x A), half steps (G)."""
    return least_s(4 * (3 * G * NC + 3 * G * A + G),
                   K1_OPS_PER_CANDIDATE * G * NC)


def k2(G: int, NS: int, A: int) -> float:
    """remap_anchors at C = 1: ids and outputs (G x NS), the table (G x A)."""
    return least_s(4 * (G * NS + G * A + G * NS))


def k4(B: int, K: int) -> float:
    """composite_rays over B rays of K samples."""
    return least_s(4 * (B * K + B * K * 4 + B + B * 5),
                   K4_OPS_PER_SAMPLE * B * K)


def k4_backward(n: int, rays: int) -> float:
    """composite_rays_backward over n = rays x K samples."""
    return least_s(4 * (n + 4 * n + rays * (1 + 5) + 4 * n),
                   K4_BWD_OPS_PER_SAMPLE * n)


def roofline_pct(trace, least: dict):
    """100 x the launches' least times over their device time, for the
    kernels {name prefix: least seconds a launch}; None where none ran."""
    lo = busy = 0.0
    for name, per_launch in least.items():
        n, s = trace.launches(name)
        lo += n * per_launch
        busy += s
    return 100.0 * lo / busy if busy > 0 else None
