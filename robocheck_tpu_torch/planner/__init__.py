"""Motion-planning layer (the ported part of `robocheck_tpu.planner`): batch
PRM and batched RRT-Connect over the fused checker, the path helpers they are
certified through, the obstacle distance grid, the clearance engine and the
continuous certifier."""
from __future__ import annotations

from .ccd import SweptCertificate, SweptCertifier, certify_multires, covering_radius
from .clearance import ClearanceEngine
from .prm import PRMConfig, PRMPlanner, PRMResult, unwrap_path
from .rrt import RRTConfig, RRTConnectPlanner, RRTResult
from .sdf import DistanceGrid, build_distance_grid, grid_from_arrays, point_triangle_distance
from .trajopt import densify, resample, snap_endpoint_branch

__all__ = [
    "PRMConfig", "PRMPlanner", "PRMResult",
    "RRTConfig", "RRTConnectPlanner", "RRTResult",
    "DistanceGrid", "build_distance_grid", "grid_from_arrays", "point_triangle_distance",
    "ClearanceEngine",
    "SweptCertificate", "SweptCertifier", "certify_multires", "covering_radius",
    "densify", "resample", "snap_endpoint_branch", "unwrap_path",
]
