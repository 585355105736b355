"""Sampling planners over the fused checker: batch PRM and batched
RRT-Connect, with the path helpers they are certified through (the ported
part of `robocheck_tpu.planner`)."""
from __future__ import annotations

from .prm import PRMConfig, PRMPlanner, PRMResult, unwrap_path
from .rrt import RRTConfig, RRTConnectPlanner, RRTResult
from .trajopt import densify, resample, snap_endpoint_branch

__all__ = [
    "PRMConfig", "PRMPlanner", "PRMResult",
    "RRTConfig", "RRTConnectPlanner", "RRTResult",
    "densify", "resample", "snap_endpoint_branch", "unwrap_path",
]
