"""The gradient planners' distance grid (K4): its CUDA kernel and its PyTorch
twin.

For every node p of the lattice ax x ay x az (node (i, j, k) at
(i * ny + j) * nz + k), the grid's value is

    sqrt(min over every obstacle triangle T of d2(p, T)),

negated where a ray from p along RAY_DIR crosses the mesh an odd number of
times (``signed``): the JAX package's `_grid_distances` and `_grid_inside`
(`robocheck_tpu/planner/sdf.py:127-178`), with d2 the squared
point-to-triangle distance of `kernels/clearance.point_tri_d2` (the clearance
scan's, K3) and the Moller-Trumbore test along the ray.

  * ``grid_table`` forms the per-triangle terms once per obstacle, with torch
    ops on its device: `kernels/clearance.tri_table`'s corners and edges,
    pvec = RAY_DIR x (c - a), the determinant's inverse (0 where flat) and
    the flat flag;
  * ``sdf_grid_cuda`` launches `rc_sdf_grid` of `csrc/clearance.cu` (tensors
    on a CUDA device only; it raises on a refused launch, with no fallback);
  * ``grid_values_reference`` is its plain PyTorch twin (any device), in the
    kernel's operation order, which `planner/sdf.build_distance_grid` runs on
    a CPU device, the CPU tests hold against JAX, and `chip_smoke.py` holds
    the kernel against on the card;
  * ``grid_values`` runs the kernel for CUDA tensors and the twin for CPU
    ones;
  * ``grid_work_counts`` counts, on the same inputs, how far each
    node-triangle pair goes (its distance's region, its ray test's stages):
    the work from which `profiling/bounds.grid_work` gives the kernel's
    bound.
"""
from __future__ import annotations

import numpy as np
import torch

from .clearance import (REGIONS, _dot, _require, point_tri_d2_parts, point_tri_region_parts,
                        tri_table)

# A slightly skewed ray direction: axis-aligned rays through a regular grid
# hit mesh edges and vertices exactly; this direction makes such
# degeneracies measure-zero in practice (`sdf.py:142-145`).
RAY_DIR = np.array([0.8775825, 0.33879128, 0.33946234], dtype=np.float32)
# Columns of a grid-table row: the scan table's 18 (a, b, c, ab, ac, bc),
# pvec (3), inv_det, flat and a zero, so a row is six 16-byte loads.
ROW = 24
# |det| below this is a triangle parallel to the ray (`sdf.py:163`).
FLAT = 1e-12
# Node x triangle elements the twin materialises per step.
_TWIN_BUDGET = 1 << 21
# The ray test's stages (`grid_work_counts`): pairs of a triangle that is not
# flat (u formed), pairs with u >= 0 (qvec and v formed), pairs that also
# pass v >= 0 and u + v <= 1 (t formed).
RAY_STAGES = ("u", "v", "t")


def _cross(u, v) -> list:
    """u x v of 3-lists of broadcastable tensors, written out (no matmul)."""
    return [u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2], u[0] * v[1] - u[1] * v[0]]


def _ray(device) -> list:
    """RAY_DIR as three 0-d float32 tensors on ``device``."""
    d = torch.as_tensor(RAY_DIR).to(device)
    return [d[i] for i in range(3)]


def grid_table(tris: torch.Tensor) -> torch.Tensor:
    """The kernel's table [nt, ROW] from triangles [nt, 9] (corners a, b, c):
    `tri_table`'s 18 columns, pvec = RAY_DIR x (c - a), det = (b - a) . pvec
    with each 3-term sum as (x + y) + z, inv_det = 1 / det where |det| >=
    FLAT else 0, flat (1.0 where |det| < FLAT) and a zero column."""
    tab = tri_table(tris)
    e1 = [tab[:, 9 + i] for i in range(3)]
    e2 = [tab[:, 12 + i] for i in range(3)]
    pvec = _cross(_ray(tris.device), e2)
    det = _dot(e1, pvec)
    flat = det.abs() < FLAT
    inv_det = torch.where(flat, 0.0, 1.0 / torch.where(flat, 1.0, det))
    return torch.cat([tab, torch.stack(pvec, dim=1), inv_det[:, None], flat.float()[:, None],
                      torch.zeros_like(inv_det)[:, None]], dim=1).contiguous()


def grid_points(axes) -> torch.Tensor:
    """The lattice's nodes [nx * ny * nz, 3] from its three axes, node
    (i, j, k) at (i * ny + j) * nz + k (numpy's meshgrid, indexing "ij")."""
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)


def _columns(table: torch.Tensor):
    """The table's corners (3 x 3-lists), edges ab and ac, pvec, inv_det and
    flat mask, as [nt] columns."""
    col = [table[:, i] for i in range(ROW)]
    return (col[0:3], col[3:6], col[6:9]), col[9:12], col[12:15], col[18:21], col[21], col[22] != 0


def _crossings(p, corners, e1, e2, pvec, inv_det, flat, d):
    """The twin's ray test of points ``p`` (3 x [C, 1]) against the table's
    triangles: bool [C, nt] crossing, and its stages (u >= 0, then also
    v >= 0 and u + v <= 1)."""
    tv = [p[i] - corners[0][i] for i in range(3)]
    u = _dot(tv, pvec) * inv_det
    q = _cross(tv, e1)
    v = _dot(q, d) * inv_det
    t = _dot(q, e2) * inv_det
    pass_u = ~flat & (u >= 0.0)
    pass_v = pass_u & (v >= 0.0) & (u + v <= 1.0)
    return pass_v & (t > 0.0), pass_u, pass_v


def grid_values_reference(points: torch.Tensor, table: torch.Tensor,
                          signed: bool = True) -> torch.Tensor:
    """Plain PyTorch twin of the kernel, on the device of its inputs: [N]
    float32 values of ``points`` [N, 3] against the ``grid_table`` [nt, ROW].
    The min of the squared distances, then one sqrt (NaN propagates through
    the min, as in the kernel); where ``signed``, negated on an odd count of
    crossings."""
    n, nt = points.shape[0], table.shape[0]
    corners, e1, e2, pvec, inv_det, flat = _columns(table)
    d = _ray(points.device)
    out = torch.empty(n, dtype=torch.float32, device=points.device)
    chunk = max(1, _TWIN_BUDGET // max(nt, 1))
    for lo in range(0, n, chunk):
        p = [points[lo : lo + chunk, i, None] for i in range(3)]
        dist = torch.sqrt(point_tri_d2_parts(p, *corners).amin(dim=1))
        if signed:
            crossing = _crossings(p, corners, e1, e2, pvec, inv_det, flat, d)[0]
            dist = torch.where(crossing.sum(dim=1) % 2 == 1, -dist, dist)
        out[lo : lo + chunk] = dist
    return out


def grid_work_counts(points: torch.Tensor, table: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """How far the node-triangle pairs of ``points`` [N, 3] against
    ``table`` go in the kernel: (int64 [len(REGIONS)] distances by the region
    they end in, int64 [len(RAY_STAGES)] pairs reaching each stage of the ray
    test). `profiling/bounds.grid_work` charges each what it needs."""
    n, nt = points.shape[0], table.shape[0]
    corners, e1, e2, pvec, inv_det, flat = _columns(table)
    d = _ray(points.device)
    regions = torch.zeros(len(REGIONS), dtype=torch.int64, device=points.device)
    stages = torch.zeros(len(RAY_STAGES), dtype=torch.int64, device=points.device)
    chunk = max(1, _TWIN_BUDGET // max(nt, 1))
    for lo in range(0, n, chunk):
        p = [points[lo : lo + chunk, i, None] for i in range(3)]
        region = point_tri_region_parts(p, *corners)
        regions += torch.bincount(region.flatten(), minlength=len(REGIONS))
        _, pass_u, pass_v = _crossings(p, corners, e1, e2, pvec, inv_det, flat, d)
        stages += torch.stack([(~flat).sum() * region.shape[0], pass_u.sum(), pass_v.sum()])
    return regions.cpu().numpy(), stages.cpu().numpy()


def sdf_grid_cuda(axes, table: torch.Tensor, signed: bool = True) -> torch.Tensor:
    """Launch K4 (`rc_sdf_grid` of `csrc/clearance.cu`) on the current
    stream: the grid [nx, ny, nz] over ``axes`` (three 1-d float32 tensors)
    against the ``grid_table`` [nt, ROW], as ``grid_values_reference`` of
    ``grid_points(axes)``. Raises on inputs the kernel does not take and on
    a refused launch."""
    ax, ay, az = axes
    for name, t in (("ax", ax), ("ay", ay), ("az", az)):
        _require(t, name, torch.float32, 1)
        if t.shape[0] == 0:
            raise ValueError(f"{name} is empty")
    _require(table, "table", torch.float32, 2)
    if table.shape[1] != ROW or table.shape[0] == 0:
        raise ValueError(f"table must be a non-empty [nt, {ROW}] grid_table, got "
                         f"{tuple(table.shape)}")
    dev = table.device
    for t in (ax, ay, az, table):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"every input must be a CUDA tensor on one device, got {t.device}")
    tab = table if table.data_ptr() % 16 == 0 else table.clone()  # copied 16 bytes at a time
    nx, ny, nz = ax.shape[0], ay.shape[0], az.shape[0]
    out = torch.empty((nx, ny, nz), dtype=torch.float32, device=dev)
    from . import _build

    lib = _build.library("clearance")
    with torch.cuda.device(dev):
        err = lib.rc_sdf_grid(ax.data_ptr(), ay.data_ptr(), az.data_ptr(), nx, ny, nz,
                              tab.data_ptr(), tab.shape[0], int(bool(signed)),
                              *(float(x) for x in RAY_DIR), out.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"rc_sdf_grid launch failed: "
                           f"{lib.rc_clearance_error_string(err).decode()} (cudaError {err})")
    sdf_grid_cuda.launches += 1
    return out


sdf_grid_cuda.launches = 0


def grid_values(axes, table: torch.Tensor, signed: bool = True) -> torch.Tensor:
    """The grid [nx, ny, nz] over ``axes`` against ``table``: K4 for CUDA
    tensors, the twin for CPU ones."""
    if table.is_cuda:
        return sdf_grid_cuda(axes, table, signed)
    shape = tuple(a.shape[0] for a in axes)
    return grid_values_reference(grid_points(axes), table, signed).reshape(shape)
