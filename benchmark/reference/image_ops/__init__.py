from reference.image_ops.grid_sample import (exponential_pad, grid_sample,
                                             grid_sample_quad, pack_quad,
                                             quad_blend, quad_cells)
from reference.image_ops.resize import (avg_pool2d,
                                        resize_bilinear_align_corners)

__all__ = ["avg_pool2d", "exponential_pad", "grid_sample", "grid_sample_quad",
           "pack_quad", "quad_blend", "quad_cells",
           "resize_bilinear_align_corners"]
