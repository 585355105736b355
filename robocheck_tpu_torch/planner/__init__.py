"""Motion-planning layer (the port of `robocheck_tpu.planner`): batch PRM and
batched RRT-Connect over the fused checker, the gradient planners
(CHOMP-style trajectory optimization and SQP) over the obstacle distance
grid, the path helpers they are certified through, the clearance engine and
the continuous certifier, and the standard pipeline of seeding the
optimizer with a PRM path."""
from __future__ import annotations

import numpy as np
import torch

from ..core.types import Mesh
from .ccd import SweptCertificate, SweptCertifier, certify_multires, covering_radius
from .clearance import ClearanceEngine
from .prm import PRMConfig, PRMPlanner, PRMResult, unwrap_path
from .rrt import RRTConfig, RRTConnectPlanner, RRTResult
from .sdf import DistanceGrid, build_distance_grid, grid_from_arrays, point_triangle_distance
from .sqp import SQPConfig, SQPOptimizer, SQPResult
from .trajopt import (TrajectoryOptimizer, TrajOptConfig, TrajOptResult, densify, resample,
                      snap_endpoint_branch)

__all__ = [
    "PRMConfig", "PRMPlanner", "PRMResult",
    "RRTConfig", "RRTConnectPlanner", "RRTResult",
    "SQPConfig", "SQPOptimizer", "SQPResult",
    "TrajectoryOptimizer", "TrajOptConfig", "TrajOptResult",
    "DistanceGrid", "build_distance_grid", "grid_from_arrays", "point_triangle_distance",
    "ClearanceEngine",
    "SweptCertificate", "SweptCertifier", "certify_multires", "covering_radius",
    "densify", "resample", "snap_endpoint_branch", "unwrap_path", "plan_and_smooth",
]


def plan_and_smooth(robot: Mesh, obstacle: Mesh, start: np.ndarray, goal: np.ndarray,
                    prm_config: PRMConfig | None = None,
                    opt_config: TrajOptConfig | None = None,
                    device: torch.device | str = "cuda") -> TrajOptResult | None:
    """The full planning pipeline (`robocheck_tpu/planner/__init__.py:35-56`):
    PRM finds a feasible (jagged) path through narrow passages a local
    optimizer cannot discover; the trajectory optimizer then smooths it under
    the distance-field penalty; the fused checker certifies the result, all
    on ``device``. Returns None if the PRM finds no path."""
    prm = PRMPlanner(robot, obstacle, prm_config, device=device)
    found = prm.plan(start, goal)
    if found.path is None:
        return None
    opt = TrajectoryOptimizer(robot, obstacle, opt_config, checker=prm.checker, device=device)
    init = resample(found.path, opt.cfg.num_waypoints, opt.cfg.rot_scale)
    return opt.plan(start, goal, init=init)
