from diner_tpu_torch.geometry.cameras import (invert_pose, project_points,
                                              ray_closest_points,
                                              transform_points)
from diner_tpu_torch.geometry.normals import depth2normal
from diner_tpu_torch.geometry.rays import gen_rays
from diner_tpu_torch.geometry.slerp import PoseSlerp

__all__ = ["PoseSlerp", "depth2normal", "gen_rays", "invert_pose",
           "project_points", "ray_closest_points", "transform_points"]
