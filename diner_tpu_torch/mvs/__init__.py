"""TransMVSNet (port of diner_tpu.mvs): the cascade that writes the depth
and confidence priors the DINER readers consume, its losses and its
training (mvs/losses.py, mvs/train.py)."""

from diner_tpu_torch.mvs.checkpoint import (from_jax,
                                            load_reference_state_dict,
                                            to_reference_state_dict)
from diner_tpu_torch.mvs.net import TransMVSNet
from diner_tpu_torch.mvs.net import window_offset_stats
from diner_tpu_torch.mvs.ops import (deform_conv2d, deform_conv2d_window,
                                     depth_range_samples, depth_wta,
                                     homo_warping)

__all__ = ["TransMVSNet", "deform_conv2d", "deform_conv2d_window",
           "depth_range_samples", "depth_wta", "from_jax", "homo_warping",
           "load_reference_state_dict", "to_reference_state_dict",
           "window_offset_stats"]
