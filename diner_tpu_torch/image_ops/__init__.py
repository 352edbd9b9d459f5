from diner_tpu_torch.image_ops.grid_sample import (grid_sample,
                                                   grid_sample_quad,
                                                   pack_quad, quad_blend,
                                                   quad_cells)
from diner_tpu_torch.image_ops.resize import resize_bilinear_align_corners

__all__ = ["grid_sample", "grid_sample_quad", "pack_quad", "quad_blend",
           "quad_cells", "resize_bilinear_align_corners"]
