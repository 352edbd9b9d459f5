from diner_tpu_torch.renderer.composite import (composite, composite_outputs,
                                                sample_points)
from diner_tpu_torch.renderer.renderer import (render_flat_chunked,
                                               render_image, render_rays)

__all__ = ["composite", "composite_outputs", "render_flat_chunked",
           "render_image", "render_rays", "sample_points"]
