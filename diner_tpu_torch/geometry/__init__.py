from diner_tpu_torch.geometry.cameras import project_points, transform_points
from diner_tpu_torch.geometry.normals import depth2normal
from diner_tpu_torch.geometry.rays import gen_rays

__all__ = ["depth2normal", "gen_rays", "project_points", "transform_points"]
