"""diner_tpu_torch: the PyTorch/CUDA port of diner_tpu for NVIDIA Hopper.

The same depth-aware image-based NeRF as `diner_tpu` (depth-guided ray
sampling over MVS priors, pixel-aligned ResNet features, the view-conditioned
ResnetFC field and alpha compositing), written in PyTorch. The TPU's Pallas
kernels on the render path are hand-written CUDA C++ kernels for sm_90a
(`diner_tpu_torch/csrc/`), built with nvcc at first use.

Entry points (`serve.RenderServer`, `models.DINER.render_batch`,
`renderer.render_image`) run on the CUDA device unless the caller passes
`device="cpu"`, where every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
