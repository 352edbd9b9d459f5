from diner_tpu_torch.renderer.composite import (composite, composite_outputs,
                                                sample_points)
from diner_tpu_torch.renderer.renderer import (render_flat_chunked,
                                               render_flat_pipelined,
                                               render_image, render_rays)
from diner_tpu_torch.renderer.sharded import render_image_sharded

__all__ = ["composite", "composite_outputs", "render_flat_chunked",
           "render_flat_pipelined", "render_image", "render_image_sharded",
           "render_rays", "sample_points"]
