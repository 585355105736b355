"""The float64 resolution of flagged rows: its CUDA kernel and its PyTorch twin.

K1 (`kernels.megakernel`) gives each configuration one byte: bit 0 valid,
bit 1 a live pair flagged coplanar, bit 2 a pair whose float32 verdict
rounding could flip. A valid row with bit 1 or bit 2 set is re-checked in
float64, exactly as the host oracle `rc_oracle_check`
(`native/robocheck_native.cpp:556-636`) checks it: the pose in float64 from
the float32 configuration, the mesh-box gate, the closed box test of each
triangle pair and the exact Moller test with its coplanar 2-D path. Every
other row keeps bit 0. The result is one byte a row, the resolved verdict
(1 collision-free, 0 colliding), which a caller fetches and views as bool.

  * ``resolve_rows_cuda`` launches the kernel of `csrc/resolve.cu` (tensors
    on a CUDA device only), after K1 on the same stream, with no host sync;
  * ``resolve_rows_reference`` is its plain PyTorch twin (any device): the
    same operations as separate torch ops, so it equals the kernel bit for
    bit on the card; ``resolve_rows`` picks one by the rows' device.

Both add to ``counts`` (two int64 on the rows' device): the rows re-checked
and those found colliding.

Tables (``ResolveTables.build``, once per mesh pair, on one device): every
robot vertex and the robot's triangles, as the oracle reads them; the
obstacle's triangle corners and boxes in float64, in Morton order of their
centroids; the box of every obstacle corner (the gate); and, for the
kernel's cull, the triangles' boxes and the box of each run of GROUP
triangles rounded outward to float32. The order, the groups and the rounded
boxes only prune pairs whose closed float64 box test fails: the verdict is
the same predicate over the same pairs as the oracle's.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.types import Mesh
from ..utils.morton import morton_argsort
from .front import _require

# Obstacle triangles a group box covers in the kernel's cull.
GROUP = 32
# Pair elements the twin's box test materialises per step (bounds its memory).
_PAIR_BUDGET = 1 << 22
_BIG = 1e300  # the oracle's empty box


@dataclasses.dataclass(frozen=True)
class ResolveTables:
    """The mesh pair in float64 on one device (``build``)."""

    rob_verts: torch.Tensor  # [nrv, 3] f64: every robot vertex
    rob_tris: torch.Tensor  # [nrt, 3] int32
    obs_tri: torch.Tensor  # [nto, 9] f64: corners c0, c1, c2 (x, y, z each)
    obs_box: torch.Tensor  # [nto, 6] f64: lo x, y, z, hi x, y, z
    obs_mesh: torch.Tensor  # [6] f64: box of every obstacle corner
    # [nto + ceil(nto / GROUP), 6] f32: obs_box, then the box of each run of
    # GROUP triangles, rounded outward (the kernel's prefilter)
    boxes32: torch.Tensor

    @staticmethod
    def build(robot: Mesh, obstacle: Mesh, device: torch.device | str) -> "ResolveTables":
        corners = np.asarray(obstacle.vertices, np.float64)[np.asarray(obstacle.triangles)]
        nto = corners.shape[0]
        if nto:
            corners = corners[morton_argsort(corners.mean(axis=1))]
        lo, hi = corners.min(axis=1), corners.max(axis=1)  # [nto, 3] each
        box = np.concatenate([lo, hi], axis=1)
        groups = np.array([np.concatenate([lo[g:g + GROUP].min(axis=0),
                                           hi[g:g + GROUP].max(axis=0)])
                           for g in range(0, nto, GROUP)]).reshape(-1, 6)
        mesh = (np.concatenate([lo.min(axis=0), hi.max(axis=0)]) if nto
                else np.array([_BIG] * 3 + [-_BIG] * 3))

        def put(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a, dtype)).to(device).contiguous()

        return ResolveTables(put(robot.vertices, np.float64),
                             put(np.asarray(robot.triangles).reshape(-1, 3), np.int32),
                             put(corners.reshape(nto, 9), np.float64), put(box, np.float64),
                             put(mesh, np.float64),
                             put(outward_f32(np.concatenate([box, groups])), np.float32))

    @functools.cached_property
    def kernel_args(self) -> tuple:
        """The kernel's table arguments (rob_verts, nrv, rob_tris, nrt,
        obs_tri, nto, boxes32, ng, obs_mesh), the tables checked once for
        what the kernel takes (they are frozen). Raises on tables off a CUDA
        device."""
        dev = self.rob_verts.device
        nrv, nrt, nto = self.rob_verts.shape[0], self.rob_tris.shape[0], self.obs_tri.shape[0]
        ng = -(-nto // GROUP)
        _require(self.rob_verts, "rob_verts", (nrv, 3), dev, torch.float64)
        _require(self.rob_tris, "rob_tris", (nrt, 3), dev, torch.int32)
        _require(self.obs_tri, "obs_tri", (nto, 9), dev, torch.float64)
        _require(self.boxes32, "boxes32", (nto + ng, 6), dev)
        _require(self.obs_mesh, "obs_mesh", (6,), dev, torch.float64)
        return (self.rob_verts.data_ptr(), nrv, self.rob_tris.data_ptr(), nrt,
                self.obs_tri.data_ptr(), nto, self.boxes32.data_ptr(), ng,
                self.obs_mesh.data_ptr())


def outward_f32(boxes: np.ndarray) -> np.ndarray:
    """[k, 6] float64 boxes (lo x, y, z, hi x, y, z) -> float32 boxes that
    hold them: each lo rounded down, each hi rounded up."""
    out = boxes.astype(np.float32)
    lo, hi = out[:, :3], out[:, 3:]
    lo[:] = np.where(lo > boxes[:, :3], np.nextafter(lo, np.float32(-np.inf)), lo)
    hi[:] = np.where(hi < boxes[:, 3:], np.nextafter(hi, np.float32(np.inf)), hi)
    return out


# --------------------------------------------------------------------------
# The plain PyTorch twin: `rc_oracle_check`'s operations, pair by pair, as
# torch ops (the oracle's NaN behaviour included: its fmin / fmax, its
# selects and its permutation of the interval's corners).
# --------------------------------------------------------------------------

def _cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.stack([u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1],
                        u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2],
                        u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]], dim=-1)


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1] + u[..., 2] * v[..., 2]


def _dominant_axis(v: torch.Tensor) -> torch.Tensor:
    ax, ay, az = v[..., 0].abs(), v[..., 1].abs(), v[..., 2].abs()
    return torch.where((ax >= ay) & (ax >= az), 0, torch.where(ay >= az, 1, 2))


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[p, i[p]] of [P, 3] x and [P] i."""
    return x.gather(1, i[:, None])[:, 0]


def _interval(t: torch.Tensor, e: torch.Tensor, ax: torch.Tensor):
    """(lo, hi) of each triangle ``t`` [P, 3, 3] on the planes' line along
    axis ``ax`` [P], its signed distances ``e`` [P, 3]: the oracle's
    `interval` and `alone_corner`."""
    alone = torch.where(e[:, 0] * e[:, 1] > 0, 2, torch.where(e[:, 0] * e[:, 2] > 0, 1, 0))
    o1, o2 = (alone + 1) % 3, (alone + 2) % 3
    p = t.gather(2, ax[:, None, None].expand(-1, 3, 1))[..., 0]  # [P, 3]
    pa, pb, pc = _take(p, alone), _take(p, o1), _take(p, o2)
    da, db, dc = _take(e, alone), _take(e, o1), _take(e, o2)
    ta = pa + (pb - pa) * da / (da - db)
    tb = pa + (pc - pa) * da / (da - dc)
    first = ta < tb
    return torch.where(first, ta, tb), torch.where(first, tb, ta)


def _orient2d(a, b, c):
    return (b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1]) - (
        b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0])


def _on_segment(p, q, r):
    return ((torch.fmin(p[..., 0], q[..., 0]) <= r[..., 0])
            & (r[..., 0] <= torch.fmax(p[..., 0], q[..., 0]))
            & (torch.fmin(p[..., 1], q[..., 1]) <= r[..., 1])
            & (r[..., 1] <= torch.fmax(p[..., 1], q[..., 1])))


def _segments_cross_2d(p1, p2, p3, p4):
    d1, d2 = _orient2d(p3, p4, p1), _orient2d(p3, p4, p2)
    d3, d4 = _orient2d(p1, p2, p3), _orient2d(p1, p2, p4)
    proper = (((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0))
              & (d1 != 0) & (d2 != 0) & (d3 != 0) & (d4 != 0))
    return (proper | ((d1 == 0) & _on_segment(p3, p4, p1)) | ((d2 == 0) & _on_segment(p3, p4, p2))
            | ((d3 == 0) & _on_segment(p1, p2, p3)) | ((d4 == 0) & _on_segment(p1, p2, p4)))


def _point_in_tri_2d(pt, t):
    o1 = _orient2d(t[:, 0], t[:, 1], pt)
    o2 = _orient2d(t[:, 1], t[:, 2], pt)
    o3 = _orient2d(t[:, 2], t[:, 0], pt)
    return ((o1 >= 0) & (o2 >= 0) & (o3 >= 0)) | ((o1 <= 0) & (o2 <= 0) & (o3 <= 0))


def _coplanar_overlap(a: torch.Tensor, b: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    ax = _dominant_axis(n)
    keep = torch.stack([(ax + 1) % 3, (ax + 2) % 3], dim=-1)[:, None, :].expand(-1, 3, 2)
    qa, qb = a.gather(2, keep), b.gather(2, keep)  # [P, 3, 2]
    hit = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    for i in range(3):
        for j in range(3):
            hit |= _segments_cross_2d(qa[:, i], qa[:, (i + 1) % 3], qb[:, j], qb[:, (j + 1) % 3])
    return hit | _point_in_tri_2d(qa[:, 0], qb) | _point_in_tri_2d(qb[:, 0], qa)


def tri_tri_intersect_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[P] bool: robot triangles ``a`` and obstacle triangles ``b`` ([P, 3
    corners, 3] float64) intersect, by the oracle's `tri_tri_intersect`."""
    n1 = _cross(a[:, 1] - a[:, 0], a[:, 2] - a[:, 0])
    d1 = -_dot(n1, a[:, 0])
    n2 = _cross(b[:, 1] - b[:, 0], b[:, 2] - b[:, 0])
    d2 = -_dot(n2, b[:, 0])
    e = _dot(n2[:, None, :], a) + d2[:, None]  # a vs plane(b)
    f = _dot(n1[:, None, :], b) + d1[:, None]  # b vs plane(a)
    sep = ((e > 0).all(-1) | (e < 0).all(-1) | (f > 0).all(-1) | (f < 0).all(-1))
    coplanar = (e == 0).all(-1)
    ax = _dominant_axis(_cross(n1, n2))
    lo1, hi1 = _interval(a, e, ax)
    lo2, hi2 = _interval(b, f, ax)
    crossing = ~((hi1 < lo2) | (hi2 < lo1))
    return ~sep & torch.where(coplanar, _coplanar_overlap(a, b, n1), crossing)


def posed_robot_reference(conf: torch.Tensor, tables: ResolveTables) -> torch.Tensor | None:
    """The robot's triangles [nrt, 3 corners, 3] float64 posed by the
    configuration ``conf`` (6 float32) as the oracle poses them, or None
    where the mesh box of every posed robot vertex misses the obstacle's
    (the oracle's gate: then no pair's boxes overlap)."""
    x, y, z, pitch, yaw, roll = conf.to(torch.float64).unbind()
    ca, sa = torch.cos(yaw), torch.sin(yaw)
    cb, sb = torch.cos(pitch), torch.sin(pitch)
    cc, sc = torch.cos(roll), torch.sin(roll)
    rot = ((ca * cb, ca * sb * sc - sa * cc, ca * sb * cc + sa * sc),
           (sa * cb, sa * sb * sc + ca * cc, sa * sb * cc - ca * sc),
           (-sb, cb * sc, cb * cc))
    v = tables.rob_verts
    posed = torch.stack([r[0] * v[:, 0] + r[1] * v[:, 1] + r[2] * v[:, 2] + t
                         for r, t in zip(rot, (x, y, z))], dim=-1)  # [nrv, 3]
    mesh = tables.obs_mesh
    if not posed.shape[0] or not bool(((posed.amin(0) <= mesh[3:])
                                       & (mesh[:3] <= posed.amax(0))).all()):
        return None
    return posed[tables.rob_tris.long()]


def box_pairs_reference(rob: torch.Tensor, tables: ResolveTables):
    """(robot, obstacle) triangle indices of the pairs whose boxes pass the
    oracle's closed box test, robot triangles ``rob`` [nrt, 3, 3], in steps
    of at most _PAIR_BUDGET tested pairs."""
    r_lo, r_hi = rob.amin(1), rob.amax(1)
    o_lo, o_hi = tables.obs_box[:, :3], tables.obs_box[:, 3:]
    step = max(1, _PAIR_BUDGET // max(1, o_lo.shape[0]))
    for lo in range(0, rob.shape[0], step):
        a_lo, a_hi = r_lo[lo:lo + step, None], r_hi[lo:lo + step, None]
        ri, oi = (~((a_lo > o_hi) | (o_lo > a_hi)).any(-1)).nonzero(as_tuple=True)
        yield lo + ri, oi


def resolve_row_reference(conf: torch.Tensor, tables: ResolveTables) -> bool:
    """Whether the configuration ``conf`` (6 float32) is collision-free,
    by the oracle's steps in float64 on ``conf``'s device."""
    rob = posed_robot_reference(conf, tables)
    if rob is None:
        return True
    obs = tables.obs_tri.view(-1, 3, 3)
    return not any(bool(tri_tri_intersect_reference(rob[ri], obs[oi]).any())
                   for ri, oi in box_pairs_reference(rob, tables))


def resolve_rows_reference(packed: torch.Tensor, confs: torch.Tensor, tables: ResolveTables,
                           counts: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's plain PyTorch twin (any device): [n] uint8 K1 bytes and
    [n, 6] float32 configurations -> [n] uint8 resolved verdicts, adding the
    rows re-checked and those found colliding to ``counts`` (two int64) if
    given."""
    out = packed & 1
    rows = (((packed & 1) == 1) & ((packed & 6) != 0)).nonzero()[:, 0].tolist()
    colliding = 0
    for r in rows:
        if not resolve_row_reference(confs[r], tables):
            out[r] = 0
            colliding += 1
    if counts is not None:
        counts += torch.tensor([len(rows), colliding], dtype=torch.int64, device=counts.device)
    return out


# --------------------------------------------------------------------------
# The CUDA kernel's wrapper.
# --------------------------------------------------------------------------

def resolve_rows_cuda(packed: torch.Tensor, confs: torch.Tensor, tables: ResolveTables,
                      counts: torch.Tensor) -> torch.Tensor:
    """Launch the kernel of `csrc/resolve.cu` on the current stream: the
    same bytes as ``resolve_rows_reference``, the same additions to
    ``counts`` (two int64 on the rows' device). Raises on inputs the kernel
    does not take and on a refused launch; makes no host sync."""
    from . import _build

    if not packed.is_cuda:
        raise ValueError(f"packed must be a CUDA tensor, got {packed.device}")
    dev = packed.device
    n = packed.shape[0]
    _require(packed, "packed", (n,), dev, torch.uint8)
    _require(confs, "confs", (n, 6), dev)
    _require(counts, "counts", (2,), dev, torch.int64)
    if tables.rob_verts.device != dev:
        raise ValueError(f"tables must be on {dev}, got {tables.rob_verts.device}")
    args = tables.kernel_args
    out = torch.empty((n,), dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    lib = _build.library("resolve")
    with torch.cuda.device(dev):
        err = lib.rc_resolve(packed.data_ptr(), confs.data_ptr(), n, *args, out.data_ptr(),
                             counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"rc_resolve launch failed: "
                           f"{lib.rc_resolve_error_string(err).decode()} (cudaError {err})")
    resolve_rows_cuda.launches += 1
    return out


resolve_rows_cuda.launches = 0


def resolve_rows(packed: torch.Tensor, confs: torch.Tensor, tables: ResolveTables,
                 counts: torch.Tensor | None = None) -> torch.Tensor:
    """``resolve_rows_cuda`` for rows on a CUDA device (counting into a
    scratch ``counts`` if none is given), else its twin."""
    if not packed.is_cuda:
        return resolve_rows_reference(packed, confs, tables, counts)
    if counts is None:  # the kernel always counts
        counts = torch.zeros((2,), dtype=torch.int64, device=packed.device)
    return resolve_rows_cuda(packed, confs, tables, counts)
