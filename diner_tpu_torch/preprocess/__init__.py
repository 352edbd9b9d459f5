from diner_tpu_torch.preprocess.facescape import (silhouette_square_crop,
                                                  undistort_image)
from diner_tpu_torch.preprocess.rasterizer import render_depth

__all__ = ["render_depth", "undistort_image", "silhouette_square_crop"]
