"""Hand-written CUDA kernels of the render path, each beside its plain
PyTorch version. `KERNELS` maps each kernel's name to its `CudaKernel`,
whose `launches` counts the launches of the kernel."""

from diner_tpu_torch.kernels import chord, composite, likelihood, remap
from diner_tpu_torch.kernels.build import build_all
from diner_tpu_torch.kernels.chord import (likelihood_from_chord,
                                           likelihood_from_chord_plain)
from diner_tpu_torch.kernels.composite import (composite_rays,
                                               composite_rays_plain)
from diner_tpu_torch.kernels.likelihood import (likelihood_from_anchors,
                                                likelihood_from_anchors_plain)
from diner_tpu_torch.kernels.remap import remap_anchors, remap_anchors_plain

KERNELS = {
    "likelihood_from_anchors": likelihood.KERNEL,
    "remap_anchors": remap.KERNEL,
    "likelihood_from_chord": chord.KERNEL,
    "composite_rays": composite.KERNEL,
}

__all__ = ["KERNELS", "build_all", "composite_rays", "composite_rays_plain",
           "likelihood_from_anchors", "likelihood_from_anchors_plain",
           "likelihood_from_chord", "likelihood_from_chord_plain",
           "remap_anchors", "remap_anchors_plain"]
