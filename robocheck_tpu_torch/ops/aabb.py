"""AABB construction (PyTorch port of `robocheck_tpu.ops.aabb`).

AABB layout: float32 [..., 6] = (xmin, ymin, zmin, xmax, ymax, zmax).
"""
from __future__ import annotations

import torch


def vertices_aabb(vertices: torch.Tensor) -> torch.Tensor:
    """[..., V, 3] vertex sets -> [..., 6] AABBs."""
    lo = torch.amin(vertices, dim=-2)
    hi = torch.amax(vertices, dim=-2)
    return torch.cat([lo, hi], dim=-1)


def triangle_aabbs(tri_vertices: torch.Tensor) -> torch.Tensor:
    """[..., T, 3 (corner), 3 (xyz)] -> [..., T, 6] per-triangle AABBs."""
    lo = torch.amin(tri_vertices, dim=-2)
    hi = torch.amax(tri_vertices, dim=-2)
    return torch.cat([lo, hi], dim=-1)


def aabb_overlap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-interval overlap on all 3 axes (``a_min <= b_max && b_min <=
    a_max``, `broad-phase.cu:5-8`), broadcasting over leading dims."""
    per_axis = (a[..., :3] <= b[..., 3:]) & (b[..., :3] <= a[..., 3:])
    return per_axis.all(dim=-1)
