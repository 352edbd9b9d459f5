from reference.geometry.cameras import (invert_pose, project_points,
                                        ray_closest_points, transform_points)
from reference.geometry.normals import depth2normal
from reference.geometry.rays import gen_rays

__all__ = ["depth2normal", "gen_rays", "invert_pose", "project_points",
           "ray_closest_points", "transform_points"]
