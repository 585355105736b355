"""Obstacle distance fields (PyTorch port of `robocheck_tpu.planner.sdf`).

A signed distance grid to the obstacle surface, computed once per obstacle
mesh (on a CUDA device by K4, `kernels/sdf.sdf_grid_cuda`; on the CPU by its
torch-ops twin) and queried with differentiable trilinear interpolation.
The gradient planners descend it; the grid backend of the continuous
certifier (`planner/ccd.py`) bounds clearances with it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import Mesh
from ..kernels.clearance import point_tri_d2
from ..kernels.sdf import grid_cull, grid_order, grid_table, grid_values
from ..runtime.device import resolve as resolve_device


def point_triangle_distance(points: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """Exact point-to-triangle distances, broadcast over pair dims
    (`sdf.py:26-88`): ``points`` [..., 3], ``tri`` [..., 3, 3] -> [...].
    The closest point by Ericson's branch-free region classification
    (`kernels.clearance.point_tri_d2`), then the norm."""
    return torch.sqrt(point_tri_d2(points, tri))


@dataclasses.dataclass(frozen=True)
class DistanceGrid:
    """Signed distance field on a regular grid with trilinear queries."""

    values: torch.Tensor  # [nx, ny, nz] float32 distances
    origin: torch.Tensor  # [3] grid corner (node 0)
    spacing: torch.Tensor  # [3] cell sizes
    # The clamp's upper bound, shape - 1.0001 in float32 on the values'
    # device: made once here, not uploaded on every query.
    upper: torch.Tensor = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        shape = torch.tensor(self.values.shape, dtype=torch.float32, device=self.values.device)
        object.__setattr__(self, "upper", shape - 1.0001)

    def query(self, points: torch.Tensor) -> torch.Tensor:
        """Differentiable trilinear interpolation; clamps outside the grid
        (`sdf.py:99-124`). ``points`` [..., 3] -> [...]."""
        g = (points - self.origin) / self.spacing
        g = torch.minimum(torch.clamp(g, min=0.0), self.upper)
        i0 = torch.floor(g).to(torch.int64)
        f = g - i0.to(torch.float32)

        def at(dx, dy, dz):
            return self.values[i0[..., 0] + dx, i0[..., 1] + dy, i0[..., 2] + dz]

        fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
        c00 = at(0, 0, 0) * (1 - fx) + at(1, 0, 0) * fx
        c10 = at(0, 1, 0) * (1 - fx) + at(1, 1, 0) * fx
        c01 = at(0, 0, 1) * (1 - fx) + at(1, 0, 1) * fx
        c11 = at(0, 1, 1) * (1 - fx) + at(1, 1, 1) * fx
        c0 = c00 * (1 - fy) + c10 * fy
        c1 = c01 * (1 - fy) + c11 * fy
        return c0 * (1 - fz) + c1 * fz


def grid_from_arrays(values, origin, spacing, device="cuda") -> DistanceGrid:
    """A grid from arrays (e.g. the JAX package's `DistanceGrid` fields as
    numpy), as float32 tensors on ``device``."""
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.array(a, np.float32)).to(dev)

    return DistanceGrid(values=f32(values), origin=f32(origin), spacing=f32(spacing))


def build_distance_grid(obstacle: Mesh, resolution: int = 64, padding: float = 0.25,
                        signed: bool = True, device="cuda") -> DistanceGrid:
    """The obstacle's distance grid on ``device`` (`sdf.py:181-218`):
    ``resolution`` nodes per axis over the obstacle's box grown by
    ``padding`` of its extent on each side. ``signed`` (watertight meshes)
    negates the distances of nodes inside by the parity of crossings along
    `kernels.sdf.RAY_DIR`: with an unsigned field the interior of a solid
    looks far from the surface and becomes a false haven for an optimizer.
    The grid is one K4 launch on a CUDA device over ``grid_inputs``, which
    skips the triangle groups that cannot move a node, and the full twin
    `grid_values_reference` on the CPU: the same bits."""
    g = grid_inputs(obstacle, resolution, padding, device)
    dev = g["table"].device
    return DistanceGrid(values=grid_values(g["axes"], g["table"], g["cull"], signed),
                        origin=torch.as_tensor(g["origin"].astype(np.float32)).to(dev),
                        spacing=torch.as_tensor(g["spacing"].astype(np.float32)).to(dev))


def grid_inputs(obstacle: Mesh, resolution: int = 64, padding: float = 0.25,
                device="cuda") -> dict:
    """What K4 reads for ``obstacle``'s grid, formed once on the host and
    moved to ``device``: the lattice's "axes" (``grid_axes``), the triangles'
    grid "table" in their Morton order and its "cull" (`kernels.sdf.
    grid_order`, `grid_table`, `grid_cull`), with the lattice's "origin"
    and "spacing" (float64)."""
    dev = resolve_device(device)
    axes, lo, spacing = grid_axes(obstacle, resolution, padding)
    tri = torch.as_tensor(obstacle.triangle_vertices.astype(np.float32).reshape(-1, 9))
    table = grid_table(grid_order(tri).to(dev))
    return {"axes": [a.to(dev) for a in axes], "table": table, "cull": grid_cull(axes, table),
            "origin": lo, "spacing": spacing}


def grid_axes(obstacle: Mesh, resolution: int = 64, padding: float = 0.25):
    """The lattice of `build_distance_grid`: (three float32 CPU tensors of
    ``resolution`` nodes, its corner and its spacing in float64) over the
    obstacle's box grown by ``padding`` of its extent on each side, as
    `sdf.py:197-205` forms them (numpy's linspace in float64, then
    float32)."""
    aabb = obstacle.aabb
    lo = aabb[:3].astype(np.float64)
    hi = aabb[3:].astype(np.float64)
    ext = hi - lo
    lo = lo - padding * ext
    hi = hi + padding * ext
    spacing = (hi - lo) / (resolution - 1)
    axes = [torch.from_numpy(np.linspace(lo[k], hi[k], resolution).astype(np.float32))
            for k in range(3)]
    return axes, lo, spacing
