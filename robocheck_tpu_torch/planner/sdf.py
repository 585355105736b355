"""Obstacle distance fields (PyTorch port of `robocheck_tpu.planner.sdf`).

A signed distance grid to the obstacle surface, computed once per obstacle
mesh as a dense batched point-to-triangle distance (chunked torch ops on an
explicit device) and queried with differentiable trilinear interpolation.
The gradient planners descend it; the grid backend of the continuous
certifier (`planner/ccd.py`) bounds clearances with it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.types import Mesh
from ..kernels.clearance import point_tri_d2
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


def _grid_distances(points: torch.Tensor, tri: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """Min distance from each point [N,3] to any triangle [T,3,3], chunked
    over points (`sdf.py:127-139`)."""
    out = torch.empty(points.shape[0], dtype=points.dtype, device=points.device)
    for lo in range(0, points.shape[0], chunk):
        d = point_triangle_distance(points[lo : lo + chunk, None, :], tri[None])
        out[lo : lo + chunk] = d.amin(dim=1)
    return out


# Slightly skewed ray direction: axis-aligned rays through a regular grid hit
# mesh edges and vertices exactly; this direction makes such degeneracies
# measure-zero in practice.
_RAY_DIR = np.array([0.8775825, 0.33879128, 0.33946234], dtype=np.float32)


def _cross(u, v):
    """u x v for [..., 3] tensors, written out (no matmul)."""
    return torch.stack([u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
                        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
                        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]], dim=-1)


def _grid_inside(points: torch.Tensor, tri: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """Inside/outside by ray-crossing parity (watertight meshes): a fixed
    ray from each point, Moller-Trumbore crossings counted, odd -> inside
    (`sdf.py:148-178`)."""
    d = torch.as_tensor(_RAY_DIR).to(points.device)
    v0 = tri[:, 0, :]
    e1 = tri[:, 1, :] - v0  # [T,3]
    e2 = tri[:, 2, :] - v0
    pvec = _cross(d[None, :], e2)  # [T,3]
    det = (e1 * pvec).sum(-1)  # [T]
    flat = det.abs() < 1e-12
    inv_det = torch.where(flat, 0.0, 1.0 / torch.where(flat, 1.0, det))
    out = torch.empty(points.shape[0], dtype=torch.bool, device=points.device)
    for lo in range(0, points.shape[0], chunk):
        tvec = points[lo : lo + chunk, None, :] - v0[None]  # [C,T,3]
        u = (tvec * pvec[None]).sum(-1) * inv_det[None]
        qvec = _cross(tvec, e1[None])
        v = (qvec * d).sum(-1) * inv_det[None]
        t = (qvec * e2[None]).sum(-1) * inv_det[None]
        crossing = (~flat[None] & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0))
        out[lo : lo + chunk] = crossing.sum(1) % 2 == 1
    return out


def build_distance_grid(obstacle: Mesh, resolution: int = 64, padding: float = 0.25,
                        signed: bool = True, device="cuda") -> DistanceGrid:
    """The obstacle's distance grid on ``device`` (`sdf.py:181-218`):
    ``resolution`` nodes per axis over the obstacle's box grown by
    ``padding`` of its extent on each side. ``signed`` (watertight meshes)
    negates the distances of nodes inside by ray parity: with an unsigned
    field the interior of a solid looks far from the surface and becomes a
    false haven for an optimizer."""
    dev = resolve_device(device)
    aabb = obstacle.aabb
    lo = aabb[:3].astype(np.float64)
    hi = aabb[3:].astype(np.float64)
    ext = hi - lo
    lo = lo - padding * ext
    hi = hi + padding * ext
    spacing = (hi - lo) / (resolution - 1)

    axes = [np.linspace(lo[k], hi[k], resolution) for k in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    pts = torch.as_tensor(
        np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)).to(dev)
    tri = torch.as_tensor(obstacle.triangle_vertices.astype(np.float32)).to(dev)
    d = _grid_distances(pts, tri)
    if signed:
        d = torch.where(_grid_inside(pts, tri), -d, d)
    return DistanceGrid(values=d.reshape(resolution, resolution, resolution),
                        origin=torch.as_tensor(lo.astype(np.float32)).to(dev),
                        spacing=torch.as_tensor(spacing.astype(np.float32)).to(dev))
