"""Depth-map fusion to point clouds (port of diner_tpu.fusion): the
geometric-consistency filters ("normal", "dynamic"), the fusibile-style
consensus fusion and binary PLY IO with a host C++ writer."""

from diner_tpu_torch.fusion.consensus import consensus_fusion
from diner_tpu_torch.fusion.consistency import (check_geometric_consistency,
                                                depths_to_world_points,
                                                filter_depths,
                                                filter_depths_dynamic,
                                                reproject_with_depth)
from diner_tpu_torch.fusion.ply import read_ply, read_ply_mesh, write_ply

__all__ = ["check_geometric_consistency", "consensus_fusion",
           "depths_to_world_points", "filter_depths", "filter_depths_dynamic",
           "read_ply", "read_ply_mesh", "reproject_with_depth", "write_ply"]
