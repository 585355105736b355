"""The fused collision check: host tables, its CUDA kernel and its PyTorch twin.

PyTorch port of `robocheck_tpu.kernels.megakernel` (the Pallas `_kernel` +
`_one_config`). One call checks a batch of pose rows against the obstacle:
pose the robot's pre-gathered triangle corners, per-triangle planes and
boxes, the mesh-box broad phase, the (robot tile x obstacle group) gate, and
the Moller interval test on every pair whose triangle boxes overlap, with an
any-hit exit. Each configuration yields one byte: bit 0 = valid (no
intersecting pair), bit 1 = some live pair was flagged coplanar, bit 2 = some
box-overlapping pair is uncertain: not live as computed (the +-TOL band),
but each triangle may straddle the other's plane itself once each signed
distance moves by its float32 rounding bound; or live, with an interval test
that moving each interval end by its rounding bound could flip (a tie, which
is neither a hit nor a miss).
Valid rows with bit 1 or bit 2 are resolved in float64 on the rows' device
by `kernels.resolve` (``check_valid_resolved``).

Two implementations share the tables and the arithmetic order of the Pallas
kernel (not `ops.narrow`'s, which rounds the interval endpoint differently):

  * ``check_poses_cuda`` launches the hand-written kernel of
    `csrc/megakernel.cu` (tensors on a CUDA device only);
  * ``check_poses_reference`` is its plain PyTorch twin (any device), which
    the CPU tests run and the GPU smoke check holds the kernel against.

The same pair exists for the counter output (``check_poses_stats_cuda`` /
``check_poses_stats_reference``, int32 [B, OUT_COLS]), and
``check_poses_stage_cuda`` launches the kernel's stage-isolating variants
(`STAGES`), whose plain expectation is the byte 1 on every row.

``check_poses`` / ``check_poses_stats`` take the kernel for rows on a CUDA
device and the twin otherwise, as ``poses_from_confs`` does.

Host tables (``MegaKernelPrep``), Morton-ordered like the JAX package's:
  * rob_base   [10, Tr]: rows 0-8 corner coordinates c0x,c0y,c0z,...,c2z,
                row 9 = 1 for a real triangle, 0 for padding (padding corners
                are zeros, which posing moves to the pose's translation, so
                they must be masked).
  * obs        [To, 20]: cols 0-8 corners, 9-11 plane normal, 12 plane d,
                13-15 box lo, 16-18 box hi, 19 zero (a row is five 16-byte
                vectors). Padding rows carry the empty box (+inf, -inf).
  * obs_mesh   [6]: box of the referenced obstacle vertices (lo, hi).
  * obs_groups [To / GROUP, 6]: box of each group of GROUP obstacle triangles.
  * rob_verts  [3, nv]: the robot's vertex table (``robot_vertices``: the
                distinct corners of the real triangles) and rob_padded,
                whether rob_base has a padding column: derived from rob_base
                (built by ``to`` on the tables' device), K5's input
                (`csrc/front.cu`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.constants import LANE, round_up
from ..core.types import Mesh, validate_confs
from ..ops.narrow import is_coplanar, no_overlap
from ..ops.transform import rotation_matrices
from ..profiling.timers import span
from ..runtime.device import resolve as resolve_device
from ..utils.morton import morton_argsort
from .front import _require, poses_from_confs_cuda, robot_bounds_cuda
from .resolve import ResolveTables, resolve_rows

# Obstacle table columns (the JAX obs_t's first 19 columns, same indices).
_O_C, _O_N, _O_D, _O_LO, _O_HI = 0, 9, 12, 13, 16
OBS_COLS = 20
# Obstacle triangles per group box; both tables pad their triangle count to
# a multiple of it (as the JAX tables do), so the two packages' tables are
# equal array for array.
GROUP = LANE
# Robot triangles per tile of the CUDA kernel's gate (one per lane of a warp).
ROB_TILE = 32
# Fill value of masked robot boxes in the mesh-box reduction (`megakernel.py:403`).
_BIG = 3.0e38
# Columns of the counter output (`megakernel.py:1116-1120`): 0 valid,
# 1 coplanar, 2 num_pairs (box-overlapping pairs of real robot triangles in
# the tile pairs visited before the any-hit exit), 3 broad, 4 nfull, 5 ngate,
# 6 nrest, 7 zero. Columns 4-6 count this package's tile pairs (ROB_TILE robot
# x GROUP obstacle triangles), not the JAX kernel's 128 x 128 tiles: nfull =
# gated tile pairs with at least one box-overlapping pair, ngate = gated tile
# pairs with none, nrest = tile pairs with at least one live pair (both planes
# straddle the +-TOL band).
OUT_COLS = 8
# Stage-isolating variants of the CUDA kernel, by their code in
# `csrc/megakernel.cu`: pose + broad phase + gate then the epilogue
# (`sweep=False`, `megakernel.py:625-643`); the sweep up to the pair queue,
# box tests only (`stage_cap=0`); box tests and plane stage, never the
# interval stage (`stage_cap=1`, `megakernel.py:761-774`); the full sweep with
# every divide of the interval stage and the coplanar test replaced by a
# multiply (`stage_cap=3`, `_probe_div`, `megakernel.py:94-97, 775`).
STAGES = {"nosweep": 1, "maskonly": 2, "planesonly": 3, "nodiv": 4}
# Rounding-bound factors of a signed distance (2 * gamma_4, u = 2**-24) and
# of an interval end (32u), as `kErr` and `kErrI` in `csrc/megakernel.cu`,
# which derives them.
_ERR = 4.7684e-07
_ERR_I = 1.9073486e-06
# Pair elements the twin materialises per step (bounds its memory).
_PAIR_BUDGET = 1 << 24
# Rows a twin poses and tests at once: `_posed_robot` keeps about 25
# [B, Tr] float32 arrays, ~100 KB a row for a 1,024-triangle robot.
TWIN_ROWS = 16384


@dataclasses.dataclass(frozen=True)
class MegaKernelPrep:
    """Mesh-pair tables, as numpy arrays (``build``) or as tensors on one
    device (``to``)."""

    rob_base: np.ndarray | torch.Tensor  # [10, Tr] f32
    obs: np.ndarray | torch.Tensor  # [To, OBS_COLS] f32
    obs_mesh: np.ndarray | torch.Tensor  # [6] f32
    obs_groups: np.ndarray | torch.Tensor  # [To // GROUP, 6] f32

    @staticmethod
    def build(robot: Mesh, obstacle: Mesh, morton: bool = True) -> "MegaKernelPrep":
        """The JAX `MegaKernelPrep.build` (`megakernel.py:930-993`) in this
        layout: same Morton order, same float32 obstacle-plane op order."""

        def corners(mesh: Mesh) -> np.ndarray:
            tv = mesh.vertices[mesh.triangles].astype(np.float64)  # [T,3,3]
            if morton:
                tv = tv[morton_argsort(tv.mean(axis=1))]
            return tv

        rob_tv = corners(robot)
        tr = round_up(rob_tv.shape[0], GROUP)
        rob_base = np.zeros((10, tr), dtype=np.float32)
        rob_base[0:9, : rob_tv.shape[0]] = rob_tv.reshape(-1, 9).T.astype(np.float32)
        rob_base[9, : rob_tv.shape[0]] = 1.0

        obs_tv = corners(obstacle).astype(np.float32)
        nt = obs_tv.shape[0]
        to = round_up(nt, GROUP)
        obs = np.zeros((to, OBS_COLS), dtype=np.float32)
        obs[:nt, _O_C : _O_C + 9] = obs_tv.reshape(nt, 9)
        # Planes in f32, in the op order of `megakernel.py:952-956`.
        e1 = obs_tv[:, 1] - obs_tv[:, 0]
        e2 = obs_tv[:, 2] - obs_tv[:, 1]
        n = np.cross(e1, e2)
        d = -np.sum(n * obs_tv[:, 0], axis=-1)
        obs[:nt, _O_N : _O_N + 3] = n
        obs[:nt, _O_D] = d
        obs[:, _O_LO : _O_LO + 3] = np.inf
        obs[:, _O_HI : _O_HI + 3] = -np.inf
        obs[:nt, _O_LO : _O_LO + 3] = obs_tv.min(axis=1)
        obs[:nt, _O_HI : _O_HI + 3] = obs_tv.max(axis=1)

        obs_mesh = np.concatenate([obs_tv.reshape(-1, 3).min(axis=0),
                                   obs_tv.reshape(-1, 3).max(axis=0)])
        obs_groups = np.zeros((to // GROUP, 6), dtype=np.float32)
        obs_groups[:, 0:3] = np.inf
        obs_groups[:, 3:6] = -np.inf
        for g in range(to // GROUP):
            lo, hi = g * GROUP, min((g + 1) * GROUP, nt)
            if hi > lo:
                obs_groups[g, 0:3] = obs_tv[lo:hi].reshape(-1, 3).min(axis=0)
                obs_groups[g, 3:6] = obs_tv[lo:hi].reshape(-1, 3).max(axis=0)
        return MegaKernelPrep(rob_base, obs, obs_mesh.astype(np.float32),
                              obs_groups)

    def to(self, device: torch.device | str) -> "MegaKernelPrep":
        """The same tables as contiguous float32 tensors on ``device`` (from
        host arrays or CPU tensors), with the robot's vertex table
        (``rob_verts``) built there once."""
        prep = MegaKernelPrep(*(
            torch.as_tensor(np.asarray(a, np.float32)).to(device).contiguous()
            for a in (self.rob_base, self.obs, self.obs_mesh, self.obs_groups)
        ))
        _ = prep.rob_verts, prep.rob_padded  # built here, never on a call
        return prep

    @functools.cached_property
    def rob_verts(self) -> torch.Tensor:
        """[3, nv] f32 on rob_base's device: the robot's vertex table
        (``robot_vertices``), K5's input. Derived from rob_base at first use
        (``to`` builds it) and kept with it; a prep is frozen, so the table
        cannot go stale (``dataclasses.replace`` makes a new prep, which
        derives its own)."""
        return robot_vertices(torch.as_tensor(np.asarray(self.rob_base, np.float32))
                              if isinstance(self.rob_base, np.ndarray) else self.rob_base)

    @functools.cached_property
    def rob_padded(self) -> bool:
        """Whether rob_base has a non-real column (row 9 <= 0): K5 then folds
        the 3.0e38 sentinel into the box, as the corner twin does."""
        return bool((self.rob_base[9] <= 0.0).any())


def prep_from_arrays(rob_base: np.ndarray, obs_t: np.ndarray,
                     obs_mesh_aabb: np.ndarray,
                     obs_group_aabbs: np.ndarray) -> MegaKernelPrep:
    """The tables of a JAX `MegaKernelPrep` (its `rob_base` [16, Tr], `obs_t`
    [To, 24], `obs_mesh_aabb` [1, 8] and `obs_group_aabbs` [G, 8] fields) in
    this package's layout, so both packages can run on identical tables."""
    def f32(a):
        return np.ascontiguousarray(a, dtype=np.float32)

    return MegaKernelPrep(f32(rob_base[:10]), f32(obs_t[:, :OBS_COLS]),
                          f32(obs_mesh_aabb[0, :6]), f32(obs_group_aabbs[:, :6]))


def poses_from_confs(confs: torch.Tensor) -> torch.Tensor:
    """[B,6] configurations -> [B,16] pose rows r00,r01,r02,tx, r10,...,ty,
    r20,...,tz, 0,0,0,0 (`megakernel.py:1099-1113`): K2
    (`front.poses_from_confs_cuda`, one launch) for a CUDA tensor, the twin
    ``poses_from_confs_reference`` for a CPU one."""
    if confs.is_cuda:
        return poses_from_confs_cuda(confs.contiguous())
    return poses_from_confs_reference(confs)


def poses_from_confs_reference(confs: torch.Tensor) -> torch.Tensor:
    """K2's plain PyTorch twin (any device): `ops.transform.rotation_matrices`
    and the translations, as torch ops."""
    R = rotation_matrices(confs)
    t = confs[:, 0:3]
    pad = torch.zeros((confs.shape[0], 4), dtype=confs.dtype, device=confs.device)
    return torch.cat([R[:, 0, :], t[:, 0:1], R[:, 1, :], t[:, 1:2],
                      R[:, 2, :], t[:, 2:3], pad], dim=1)


# --------------------------------------------------------------------------
# The plain PyTorch twin.
# --------------------------------------------------------------------------

def _posed_robot(poses: torch.Tensor, rob_base: torch.Tensor) -> dict:
    """Posed corners, planes and boxes, each [B, Tr], in the operation order
    of the Pallas kernel (`megakernel.py:393-395, 407-408, 454-462`)."""
    p = [poses[:, k : k + 1] for k in range(12)]
    f = {}
    for c in range(3):
        X, Y, Z = rob_base[3 * c], rob_base[3 * c + 1], rob_base[3 * c + 2]
        for k, ax in enumerate("xyz"):
            f[f"c{c}{ax}"] = (p[4 * k] * X + p[4 * k + 1] * Y
                              + p[4 * k + 2] * Z + p[4 * k + 3])
    e1 = [f[f"c1{ax}"] - f[f"c0{ax}"] for ax in "xyz"]
    e2 = [f[f"c2{ax}"] - f[f"c1{ax}"] for ax in "xyz"]
    f["nx"] = e1[1] * e2[2] - e1[2] * e2[1]
    f["ny"] = e1[2] * e2[0] - e1[0] * e2[2]
    f["nz"] = e1[0] * e2[1] - e1[1] * e2[0]
    f["d"] = -(f["nx"] * f["c0x"] + f["ny"] * f["c0y"] + f["nz"] * f["c0z"])
    for k, ax in enumerate("xyz"):
        f[f"lo{k}"] = torch.minimum(torch.minimum(f[f"c0{ax}"], f[f"c1{ax}"]),
                                    f[f"c2{ax}"])
        f[f"hi{k}"] = torch.maximum(torch.maximum(f[f"c0{ax}"], f[f"c1{ax}"]),
                                    f[f"c2{ax}"])
    return f


def _obstacle_fields(obs: torch.Tensor) -> dict:
    f = {}
    for c in range(3):
        for k, ax in enumerate("xyz"):
            f[f"c{c}{ax}"] = obs[:, _O_C + 3 * c + k]
    f["nx"], f["ny"], f["nz"] = obs[:, _O_N], obs[:, _O_N + 1], obs[:, _O_N + 2]
    f["d"] = obs[:, _O_D]
    for k in range(3):
        f[f"lo{k}"] = obs[:, _O_LO + k]
        f[f"hi{k}"] = obs[:, _O_HI + k]
    return f


def _interval(p, d3, g3, a3):
    """Canonical permutation, interval ends (`megakernel.py:194-213`) and
    the ends' rounding bound from the distances' bounds ``g3`` and the
    projections' sums of absolute terms ``a3`` (`kErrI` in
    `csrc/megakernel.cu`, which derives it)."""
    d0, d1, d2 = d3
    c01 = ((d0 > 0) & (d1 > 0)) | ((d0 < 0) & (d1 < 0))
    c02 = ((d0 > 0) & (d2 > 0)) | ((d0 < 0) & (d2 < 0))

    def canon(x):
        return (torch.where(c01, x[0], torch.where(c02, x[0], x[1])),
                torch.where(c01, x[2], torch.where(c02, x[1], x[0])),
                torch.where(c01, x[1], x[2]))

    q, e, g, a = canon(p), canon(d3), canon(g3), canon(a3)

    def endpoint(i, j):
        dd = e[i] - e[j]
        dd = torch.where(dd == 0.0, 1.0, dd)
        w = (q[j] - q[i]).abs()
        err = _ERR_I * ((a[i] + a[j]) + w) + w * ((g[i] + g[j]) / dd.abs())
        return q[i] + (q[j] - q[i]) * (e[i] / dd), err

    t01, err01 = endpoint(0, 1)
    t12, err12 = endpoint(1, 2)
    return torch.minimum(t01, t12), torch.maximum(t01, t12), torch.maximum(err01, err12)


def _dist_err(n: dict, s: dict) -> list[torch.Tensor]:
    """Rounding bound of each signed distance n.c + d of the corners of ``s``
    to the plane of ``n`` (the `kErr` comment in `csrc/megakernel.cu`)."""
    return [_ERR * ((((n["nx"] * s[f"c{c}x"]).abs() + (n["ny"] * s[f"c{c}y"]).abs())
                     + (n["nz"] * s[f"c{c}z"]).abs()) + n["d"].abs()) for c in range(3)]


def _may_straddle(d3: list, e3: list) -> torch.Tensor:
    """Some d_i + e_i >= 0 and some d_j - e_j <= 0: the triangle may
    straddle the plane itself (no +-TOL band) within rounding."""
    up = (d3[0] + e3[0] >= 0.0) | (d3[1] + e3[1] >= 0.0) | (d3[2] + e3[2] >= 0.0)
    down = (d3[0] - e3[0] <= 0.0) | (d3[1] - e3[1] <= 0.0) | (d3[2] - e3[2] <= 0.0)
    return up & down


class PairFlags(NamedTuple):
    """Per-pair flags of the twin (``_pair_flags``)."""

    hit: torch.Tensor  # live, intervals overlap, not coplanar, not a tie
    coplanar: torch.Tensor  # live and the ratio test says coplanar
    live: torch.Tensor  # both triangles straddle the other's +-TOL band
    uncertain: torch.Tensor  # packed bit 2: a plane-stage or interval tie
    counted_hit: torch.Tensor  # the counter instance's hit: ties as computed


def _pair_flags(r: dict, o: dict) -> PairFlags:
    """Flags of each pair, fields given as 1-D tensors: plane stage,
    interval stage and the exact ratio test (`megakernel.py:133-217,
    281-303`; the separation band and the ratio test are `ops.narrow`'s,
    whose arithmetic there is the kernel's). The kernel's conservative
    coplanarity precheck only skips the exact test where it cannot fire, so
    it is left out here. ``uncertain`` (packed bit 2): not live, but each
    triangle may straddle the other's plane itself (no +-TOL band) once each
    signed distance moves by its rounding bound; or live and not coplanar,
    with an interval test that moving each interval end by its rounding
    bound could flip (a tie: not a hit)."""
    dist_o = [r["nx"] * o[f"c{c}x"] + r["ny"] * o[f"c{c}y"]
              + r["nz"] * o[f"c{c}z"] + r["d"] for c in range(3)]
    dist_r = [o["nx"] * r[f"c{c}x"] + o["ny"] * r[f"c{c}y"]
              + o["nz"] * r[f"c{c}z"] + o["d"] for c in range(3)]
    err_o, err_r = _dist_err(r, o), _dist_err(o, r)
    live = (~no_overlap(torch.stack(dist_o, dim=-1))
            & ~no_overlap(torch.stack(dist_r, dim=-1)))
    plane_tie = (~live & _may_straddle(dist_o, err_o) & _may_straddle(dist_r, err_r))

    axx, bxx = r["ny"] * o["nz"], r["nz"] * o["ny"]
    axy, bxy = r["nz"] * o["nx"], r["nx"] * o["nz"]
    axz, bxz = r["nx"] * o["ny"], r["ny"] * o["nx"]
    Dx, Dy, Dz = axx - bxx, axy - bxy, axz - bxz

    def proj(s):
        terms = [(Dx * s[f"c{c}x"], Dy * s[f"c{c}y"], Dz * s[f"c{c}z"]) for c in range(3)]
        return ([(x + y) + z for x, y, z in terms],
                [(x.abs() + y.abs()) + z.abs() for x, y, z in terms])

    (p_r, a_r), (p_o, a_o) = proj(r), proj(o)
    min_r, max_r, end_r = _interval(p_r, dist_r, err_r, a_r)
    min_o, max_o, end_o = _interval(p_o, dist_o, err_o, a_o)
    isect = ~((min_r >= max_o) | (min_o >= max_r)) & live
    coplanar = is_coplanar(torch.stack([r["nx"], r["ny"], r["nz"]], dim=-1), r["d"],
                           torch.stack([o["nx"], o["ny"], o["nz"]], dim=-1),
                           o["d"]) & live
    E = end_r + end_o
    tie = (live & ~coplanar & ((min_r + E >= max_o) | (min_o + E >= max_r))
           & (min_r < max_o + E) & (min_o < max_r + E))
    return PairFlags(isect & ~coplanar & ~tie, coplanar, live, plane_tie | tie,
                     isect & ~coplanar)


def robot_vertices(rob_base: torch.Tensor) -> torch.Tensor:
    """The robot's vertex table [3, nv] float32 (X, Y, Z rows) on
    ``rob_base``'s device: the corners of the real triangles (row 9 > 0),
    each distinct (X, Y, Z) bit pattern once (-0.0 and +0.0 kept apart), in
    ascending order of the patterns as int32, so a table always gives the
    same vertex table. K5's input (`front.robot_bounds_cuda`), built once
    per robot table (``MegaKernelPrep.to``); the alpha-1.0 robot's 3,024
    corners give 792 vertices."""
    real = rob_base[9] > 0.0
    corners = rob_base[0:9][:, real].reshape(3, 3, -1)  # [corner, axis, triangle]
    pts = corners.permute(0, 2, 1).reshape(-1, 3).contiguous()
    if not pts.shape[0]:
        return torch.zeros((3, 0), dtype=torch.float32, device=rob_base.device)
    bits = torch.unique(pts.view(torch.int32), dim=0)
    return bits.view(torch.float32).T.contiguous()


def robot_bounds(poses: torch.Tensor, tables: MegaKernelPrep) -> torch.Tensor:
    """[B,16] pose rows -> [B,6] box (lo x,y,z, hi x,y,z) of the posed robot's
    real triangles in ``tables`` (on the rows' device, from ``to``): the JAX
    package's `_robot_bounds` (`megakernel.py:1209-1228`). K5
    (`front.robot_bounds_cuda`) over the vertex table for a CUDA tensor, the
    twin ``robot_bounds_reference`` over the corner table for a CPU one. Any
    number of obstacle boxes can be tested against it (``boxes_overlap``)."""
    if poses.is_cuda:
        return robot_bounds_cuda(poses, tables.rob_verts, padded=tables.rob_padded)
    return robot_bounds_reference(poses, tables.rob_base)


def robot_bounds_reference(poses: torch.Tensor, rob_base: torch.Tensor) -> torch.Tensor:
    """The robot box's plain PyTorch twin over the corner table (any device),
    in the operation order of K1's stage 1: each corner posed as
    r0*x + r1*y + r2*z + t, masked min / max (3.0e38 / -3.0e38 where no
    triangle is real)."""
    real = rob_base[9] > 0.0
    lo_hi = [], []
    for k in range(3):
        r0, r1, r2, t = (poses[:, 4 * k + j : 4 * k + j + 1] for j in range(4))
        lo = hi = None
        for c in range(3):
            v = r0 * rob_base[3 * c] + r1 * rob_base[3 * c + 1] + r2 * rob_base[3 * c + 2] + t
            lo = v if lo is None else torch.minimum(lo, v)
            hi = v if hi is None else torch.maximum(hi, v)
        lo_hi[0].append(torch.where(real, lo, _BIG).amin(dim=1))
        lo_hi[1].append(torch.where(real, hi, -_BIG).amax(dim=1))
    return torch.stack(lo_hi[0] + lo_hi[1], dim=1)


def robot_bounds_vertices_reference(poses: torch.Tensor, rob_verts: torch.Tensor,
                                    padded: bool = True) -> torch.Tensor:
    """K5's plain PyTorch twin over the vertex table [3, nv] (any device), in
    the kernel's operation order (`csrc/front.cu`): s = r0*X + r1*Y + r2*Z a
    vertex, its min and max over the vertices (NaN-propagating), the
    translation added to the extreme that stands for every vertex
    (`finish_axis`: rounding is monotone), then, where the corner table has
    padding (``padded``), the 3.0e38 sentinel folded in as the corner twin's
    masked reduction folds it. Equal as values, NaN for NaN, to
    ``robot_bounds_reference`` over the table the vertices came from; a
    table with no real triangle gives the sentinel box."""
    n = poses.shape[0]
    if not rob_verts.shape[1]:
        return poses.new_tensor([_BIG] * 3 + [-_BIG] * 3).expand(n, 6).clone()
    big = poses.new_tensor(_BIG if padded else torch.inf)
    lo_hi = [], []
    for k in range(3):
        r0, r1, r2, t = (poses[:, 4 * k + j : 4 * k + j + 1] for j in range(4))
        s = r0 * rob_verts[0] + r1 * rob_verts[1] + r2 * rob_verts[2]
        lo_s, hi_s = s.amin(dim=1, keepdim=True), s.amax(dim=1, keepdim=True)
        lo_hi[0].append(torch.minimum(torch.where(t == -torch.inf, hi_s, lo_s) + t, big))
        lo_hi[1].append(torch.maximum(torch.where(t == torch.inf, lo_s, hi_s) + t, -big))
    return torch.cat(lo_hi[0] + lo_hi[1], dim=1)


def boxes_overlap(bounds: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """[B,6] robot boxes x [K,6] obstacle boxes -> [K,B] bool overlap on
    closed intervals (the kernel's mesh-box test)."""
    return ((bounds[None, :, :3] <= boxes[:, None, 3:])
            & (boxes[:, None, :3] <= bounds[None, :, 3:])).all(-1)


def mesh_broad(poses: torch.Tensor, tables: MegaKernelPrep) -> torch.Tensor:
    """[B,16] pose rows -> [B] bool: the posed robot's mesh box (real
    triangles only) overlaps the obstacle's (``tables.obs_mesh``) on closed
    intervals. The JAX package's `_broad_overlap` (`megakernel.py:1232-1248`),
    which is the kernel's stage 1 bit for bit: K5 over the vertex table with
    the obstacle box for a CUDA tensor, the twin ``mesh_broad_reference``
    over the corner table for a CPU one."""
    if poses.is_cuda:
        return robot_bounds_cuda(poses, tables.rob_verts, tables.obs_mesh,
                                 padded=tables.rob_padded)[1]
    return mesh_broad_reference(poses, tables.rob_base, tables.obs_mesh)


def mesh_broad_reference(poses: torch.Tensor, rob_base: torch.Tensor,
                         obs_mesh: torch.Tensor) -> torch.Tensor:
    """``mesh_broad``'s plain PyTorch twin (any device)."""
    return boxes_overlap(robot_bounds_reference(poses, rob_base), obs_mesh[None])[0]


def _box_pairs(fb: dict, o: dict, real: torch.Tensor):
    """(config, robot, obstacle) indices of every pair whose triangle boxes
    overlap on closed intervals, robot triangle real (`megakernel.py:736-739`):
    the x axis on the dense [b, Tr, To] grid, then y and z on survivors."""
    m = ((fb["lo0"][:, :, None] <= o["hi0"]) & (o["lo0"] <= fb["hi0"][:, :, None])
         & real[:, None])
    bi, ri, oi = m.nonzero(as_tuple=True)
    keep = ((fb["lo1"][bi, ri] <= o["hi1"][oi]) & (o["lo1"][oi] <= fb["hi1"][bi, ri])
            & (fb["lo2"][bi, ri] <= o["hi2"][oi]) & (o["lo2"][oi] <= fb["hi2"][bi, ri]))
    return bi[keep], ri[keep], oi[keep]


def _nonfinite_rows(poses: torch.Tensor, nonfinite: torch.Tensor | None) -> torch.Tensor:
    """[B] bool: the pose rows with a non-finite float among their 12 (K2
    gives such a row exactly where the configuration row is non-finite);
    adds their number to the int64 counter ``nonfinite`` if given, as K1
    does."""
    bad = ~torch.isfinite(poses[:, :12]).all(1)
    if nonfinite is not None:
        nonfinite += bad.sum().to(nonfinite.device)
    return bad


def _in_blocks(twin):
    """``twin`` over its rows TWIN_ROWS at a time, joined: a twin's
    temporaries grow with the rows it poses at once (the kernel's do not)."""
    @functools.wraps(twin)
    def blocked(poses: torch.Tensor, prep: MegaKernelPrep,
                nonfinite: torch.Tensor | None = None) -> torch.Tensor:
        if poses.shape[0] <= TWIN_ROWS:
            return twin(poses, prep, nonfinite)
        return torch.cat([twin(poses[lo : lo + TWIN_ROWS], prep, nonfinite)
                          for lo in range(0, poses.shape[0], TWIN_ROWS)])
    return blocked


@_in_blocks
def check_poses_reference(poses: torch.Tensor, prep: MegaKernelPrep,
                          nonfinite: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch twin of the CUDA kernel: [B,16] pose rows -> [B] uint8
    (bit 0 = valid, bit 1 = coplanar seen, bit 2 = uncertain pair seen), on
    the device of its inputs. A row with a non-finite pose float gets the
    byte 0 (invalid, nothing flagged) and is counted in ``nonfinite`` (one
    int64, if given), as in the kernel.

    A pair counts where the robot triangle is real and the two triangle boxes
    overlap on closed intervals (`megakernel.py:736-739`); the twin finds
    those pairs with ``nonzero`` and tests all of them, so its bits 1 and 2
    of a colliding configuration may differ from the kernel's (whose any-hit
    exit depends on visiting order). Valid rows agree bit for bit."""
    rob_base, obs = prep.rob_base, prep.obs
    f = _posed_robot(poses, rob_base)
    real = rob_base[9] > 0.0
    bad = _nonfinite_rows(poses, nonfinite)
    broad = mesh_broad_reference(poses, rob_base, prep.obs_mesh) & ~bad

    out = (~bad).to(torch.uint8)
    o = _obstacle_fields(obs)
    tr, to = rob_base.shape[1], obs.shape[0]
    step = max(1, _PAIR_BUDGET // (tr * to))
    for rows in broad.nonzero()[:, 0].split(step):
        fb = {key: v[rows] for key, v in f.items()}
        bi, ri, oi = _box_pairs(fb, o, real)
        pf = _pair_flags({key: v[bi, ri] for key, v in fb.items()},
                         {key: v[oi] for key, v in o.items()})
        hit, cop, unc = pf.hit, pf.coplanar, pf.uncertain
        any_hit = torch.zeros(len(rows), dtype=torch.bool, device=poses.device)
        any_cop = torch.zeros_like(any_hit)
        any_unc = torch.zeros_like(any_hit)
        any_hit[bi[hit]] = True
        any_cop[bi[cop]] = True
        any_unc[bi[unc]] = True
        out[rows] = ((~any_hit).to(torch.uint8) | (any_cop.to(torch.uint8) << 1)
                     | (any_unc.to(torch.uint8) << 2))
    return out


@_in_blocks
def check_poses_stats_reference(poses: torch.Tensor, prep: MegaKernelPrep,
                                nonfinite: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch twin of the counter kernel: [B,16] pose rows -> [B,
    OUT_COLS] int32 (the columns documented at OUT_COLS), on the device of
    its inputs. A row with a non-finite pose float gets an all-zero row and
    is counted in ``nonfinite``, as in ``check_poses_reference``.

    It tests every box-overlapping pair with no any-hit exit, and counts
    tile pairs with the kernel's gate: the box of each ROB_TILE-triangle
    robot tile (real triangles only) against each obstacle group box. Every
    box-overlapping pair lies in a gated tile pair, so on a valid row (which
    the kernel sweeps to the end) all columns equal the kernel's; on a
    colliding row the kernel's columns 2 and 4-6 count only the tile pairs
    visited before its exit and are at most these."""
    rob_base, obs = prep.rob_base, prep.obs
    f = _posed_robot(poses, rob_base)
    real = rob_base[9] > 0.0
    bad = _nonfinite_rows(poses, nonfinite)
    broad = mesh_broad_reference(poses, rob_base, prep.obs_mesh) & ~bad
    out = torch.zeros((poses.shape[0], OUT_COLS), dtype=torch.int32, device=poses.device)
    out[:, 0] = (~bad).to(torch.int32)
    out[:, 3] = broad.to(torch.int32)

    o = _obstacle_fields(obs)
    tr, to = rob_base.shape[1], obs.shape[0]
    n_tiles, n_groups = tr // ROB_TILE, to // GROUP
    n_pairs_t = n_tiles * n_groups
    g = prep.obs_groups
    step = max(1, _PAIR_BUDGET // (tr * to))
    for rows in broad.nonzero()[:, 0].split(step):
        b = len(rows)
        fb = {key: v[rows] for key, v in f.items()}
        gate = torch.ones((b, n_tiles, n_groups), dtype=torch.bool, device=poses.device)
        for k in range(3):
            t_lo = torch.where(real, fb[f"lo{k}"], _BIG).view(b, n_tiles, ROB_TILE).amin(-1)
            t_hi = torch.where(real, fb[f"hi{k}"], -_BIG).view(b, n_tiles, ROB_TILE).amax(-1)
            gate &= (t_lo[:, :, None] <= g[:, 3 + k]) & (g[:, k] <= t_hi[:, :, None])
        n_gated = gate.sum((1, 2))

        bi, ri, oi = _box_pairs(fb, o, real)
        pf = _pair_flags({key: v[bi, ri] for key, v in fb.items()},
                         {key: v[oi] for key, v in o.items()})
        hit, cop, live = pf.counted_hit, pf.coplanar, pf.live
        cell = bi * n_pairs_t + (ri // ROB_TILE) * n_groups + oi // GROUP
        full = torch.zeros(b * n_pairs_t, dtype=torch.bool, device=poses.device)
        rest = torch.zeros_like(full)
        full[cell] = True
        rest[cell[live]] = True
        any_hit = torch.zeros(b, dtype=torch.bool, device=poses.device)
        any_cop = torch.zeros_like(any_hit)
        any_hit[bi[hit]] = True
        any_cop[bi[cop]] = True
        n_full = full.view(b, n_pairs_t).sum(1)
        out[rows, 0] = (~any_hit).to(torch.int32)
        out[rows, 1] = any_cop.to(torch.int32)
        out[rows, 2] = torch.bincount(bi, minlength=b).to(torch.int32)
        out[rows, 4] = n_full.to(torch.int32)
        out[rows, 5] = (n_gated - n_full).to(torch.int32)
        out[rows, 6] = rest.view(b, n_pairs_t).sum(1).to(torch.int32)
    return out


# --------------------------------------------------------------------------
# The CUDA kernel's wrapper.
# --------------------------------------------------------------------------

def _launch(entry: str, poses: torch.Tensor, prep: MegaKernelPrep, out_shape: tuple,
            out_dtype: torch.dtype, nonfinite: torch.Tensor | None,
            *extra) -> tuple[bool, torch.Tensor]:
    """Check the inputs, allocate the output and launch the C entry ``entry``
    of `csrc/megakernel.cu` on the current stream, with the non-finite row
    counter ``nonfinite`` (one int64 on the rows' device, or None). Returns
    (launched, output): an empty batch launches nothing. Raises on inputs the
    kernel does not take and on a refused launch."""
    from . import _build

    if not poses.is_cuda:
        raise ValueError(f"poses must be a CUDA tensor, got {poses.device}")
    dev = poses.device
    tr, to = prep.rob_base.shape[1], prep.obs.shape[0]
    n_groups = to // GROUP
    if tr % GROUP or to % GROUP:
        raise ValueError(f"table rows must be multiples of {GROUP}: {tr}, {to}")
    _require(poses, "poses", (poses.shape[0], 16), dev)
    _require(prep.rob_base, "rob_base", (10, tr), dev)
    _require(prep.obs, "obs", (to, OBS_COLS), dev)
    _require(prep.obs_mesh, "obs_mesh", (6,), dev)
    _require(prep.obs_groups, "obs_groups", (n_groups, 6), dev)
    if prep.obs.data_ptr() % 16:
        raise ValueError("obs must be 16-byte aligned (it is read as float4)")
    if nonfinite is not None and (nonfinite.device != dev or nonfinite.dtype != torch.int64
                                  or nonfinite.numel() != 1):
        raise ValueError(f"nonfinite must be one int64 on {dev}, got {nonfinite.dtype} "
                         f"{tuple(nonfinite.shape)} on {nonfinite.device}")
    n = poses.shape[0]
    out = torch.empty((n, *out_shape), dtype=out_dtype, device=dev)
    if n == 0:
        return False, out
    work = torch.empty((1,), dtype=torch.int32, device=dev)  # the kernel's row counter
    lib = _build.library()
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            poses.data_ptr(), n, prep.rob_base.data_ptr(), tr,
            prep.obs.data_ptr(), to, prep.obs_mesh.data_ptr(),
            prep.obs_groups.data_ptr(), n_groups, out.data_ptr(), work.data_ptr(),
            None if nonfinite is None else nonfinite.data_ptr(), *extra,
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(
            f"{entry} launch failed: {lib.rc_error_string(err).decode()} "
            f"(cudaError {err}; {lib.rc_megakernel_smem_bytes(tr, n_groups)} "
            f"bytes of shared memory for {tr} robot triangles)")
    return True, out


def check_poses_cuda(poses: torch.Tensor, prep: MegaKernelPrep,
                     nonfinite: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel of `csrc/megakernel.cu` on the current stream:
    [B,16] pose rows -> [B] uint8, same bits as ``check_poses_reference``,
    adding the non-finite rows to ``nonfinite`` (one int64 on the rows'
    device) if given. Raises on inputs the kernel does not take and on a
    refused launch."""
    launched, out = _launch("rc_megakernel_check", poses, prep, (), torch.uint8, nonfinite)
    if launched:
        check_poses_cuda.launches += 1
    return out


def check_poses_stats_cuda(poses: torch.Tensor, prep: MegaKernelPrep,
                           nonfinite: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the counter instance of the kernel: [B,16] pose rows -> [B,
    OUT_COLS] int32, columns as ``check_poses_stats_reference``'s (equal on
    valid rows; on colliding rows the counts stop at the any-hit exit), the
    non-finite rows counted as ``check_poses_cuda`` counts them."""
    launched, out = _launch("rc_megakernel_check_stats", poses, prep, (OUT_COLS,),
                            torch.int32, nonfinite)
    if launched:
        check_poses_stats_cuda.launches += 1
    return out


def check_poses_stage_cuda(poses: torch.Tensor, prep: MegaKernelPrep,
                           stage: str) -> torch.Tensor:
    """Launch the stage-isolating variant ``stage`` (a key of STAGES):
    [B,16] pose rows -> [B] uint8, which is 1 on every finite row (a variant
    never sets hit, coplanar or uncertain; its work is kept live by a runtime
    zero) and 0 on a non-finite one."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {sorted(STAGES)}, got {stage!r}")
    launched, out = _launch("rc_megakernel_check_stage", poses, prep, (), torch.uint8, None,
                            STAGES[stage], 0)
    if launched:
        check_poses_stage_cuda.launches[stage] += 1
    return out


check_poses_cuda.launches = 0
check_poses_stats_cuda.launches = 0
check_poses_stage_cuda.launches = dict.fromkeys(STAGES, 0)


def check_poses(poses: torch.Tensor, prep: MegaKernelPrep,
                nonfinite: torch.Tensor | None = None) -> torch.Tensor:
    """``check_poses_cuda`` for rows on a CUDA device, else its twin."""
    if poses.is_cuda:
        return check_poses_cuda(poses, prep, nonfinite)
    return check_poses_reference(poses, prep, nonfinite)


def check_poses_stats(poses: torch.Tensor, prep: MegaKernelPrep,
                      nonfinite: torch.Tensor | None = None) -> torch.Tensor:
    """``check_poses_stats_cuda`` for rows on a CUDA device, else its twin."""
    if poses.is_cuda:
        return check_poses_stats_cuda(poses, prep, nonfinite)
    return check_poses_stats_reference(poses, prep, nonfinite)


def valid_coplanar(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(valid, coplanar) numpy bools: bits 0 and 1 of verdict bytes."""
    return (packed & 1).astype(bool), ((packed >> 1) & 1).astype(bool)


# --------------------------------------------------------------------------
# The kernel's shared-memory budget (the port's counterpart of the JAX
# package's VMEM budget, `megakernel.py:81, 999-1028`).
# --------------------------------------------------------------------------

# Opt-in dynamic shared memory of one block on an H100
# (cudaDevAttrMaxSharedMemoryPerBlockOptin; `chip_smoke.py` reads it).
SMEM_LIMIT = 232448
# The launcher's bound on either table's rows: a queued pair packs both
# indices into 16 bits each (`launch` in `csrc/megakernel.cu`).
ROW_LIMIT = 65536


class SharedMemoryBudgetError(ValueError):
    """The mesh pair's tables do not fit one block of the kernel (or exceed
    its row limit); `kernels.chunked.make_checker` splits such pairs."""


def smem_bytes(tr: int, n_groups: int) -> int:
    """Dynamic shared memory of one block of the kernel for ``tr`` robot rows
    and ``n_groups`` obstacle groups: `Layout::bytes()` of
    `csrc/megakernel.cu` (`rc_megakernel_smem_bytes`), in Python. The tables
    (rest-frame robot corners in 32 x 33-float tile blocks, obstacle boxes,
    group boxes, real bits) once per block; per team of warps, its control
    words, pose, tile boxes, gated tile pairs and scratch."""
    warps, teams, queue, tile_block = 4, 4, 64, ROB_TILE * 33
    n_tiles = tr // ROB_TILE
    fs = -(-n_tiles // 32) * tile_block
    tables = 9 * fs + 6 * n_groups * GROUP + 6 * n_groups + n_tiles
    per_team = ((7 + warps) + 16 + 6 * n_tiles + n_tiles * n_groups
                + max(warps * 6 * 32, warps * 2 * queue))
    return 4 * (tables + teams * per_team)


class MegaKernelChecker:
    """Batched collision verdicts for one robot/obstacle mesh pair on one
    device: the CUDA kernels on a CUDA device (the default), their PyTorch
    twins on the CPU, chosen by the rows' device; nothing falls back. A pair
    whose tables do not fit the kernel raises SharedMemoryBudgetError
    (`kernels.chunked.make_checker` splits it).

    ``check_packed`` / ``check_valid`` / ``check_valid_resolved`` are the
    throughput path (one verdict byte per configuration); ``check`` (over ``broad_block`` and
    ``check_block``) is the stats path with the kernel's counter columns."""

    def __init__(self, robot: Mesh, obstacle: Mesh, device: torch.device | str = "cuda",
                 morton: bool = True):
        self.device = resolve_device(device)
        self.robot = robot
        self.obstacle = obstacle
        self.prep = MegaKernelPrep.build(robot, obstacle, morton=morton)
        # The kernel's limits, checked on every device alike.
        tr, to = self.prep.rob_base.shape[1], self.prep.obs.shape[0]
        need = smem_bytes(tr, to // GROUP)
        if need > SMEM_LIMIT or tr >= ROW_LIMIT or to >= ROW_LIMIT:
            raise SharedMemoryBudgetError(
                f"tables of {tr} robot / {to} obstacle rows need {need} bytes of shared "
                f"memory per block (limit {SMEM_LIMIT}) and rows below {ROW_LIMIT}; "
                f"use kernels.chunked.make_checker")
        self.tables = self.prep.to(self.device)
        # The float64 tables of the resolution (`kernels.resolve`), built
        # once on the device.
        self.resolve_tables = ResolveTables.build(robot, obstacle, self.device)
        # Rows with a non-finite pose float, counted by K1 (or its twin) on
        # the device; read only by ``counters``.
        self._nonfinite = torch.zeros((), dtype=torch.int64, device=self.device)
        # Rows the resolution re-checked in float64 and those it found
        # colliding, counted on the device; read only by ``counters``.
        self._resolved = torch.zeros((2,), dtype=torch.int64, device=self.device)

    def counters(self) -> dict:
        """Counts since the checker was made: {"nonfinite_rows": rows with
        a non-finite configuration that K1 (or its twin) has answered (the
        byte 0, or ``check_block``'s all-zero counter row),
        "resolved_rows": valid rows flagged coplanar or uncertain that
        ``check_valid_resolved`` re-checked in float64, "resolved_colliding":
        those of them found colliding}. One device read; no check call makes
        it."""
        nonfinite, rows, colliding = torch.cat([self._nonfinite.view(1),
                                                self._resolved]).tolist()
        return {"nonfinite_rows": nonfinite, "resolved_rows": rows,
                "resolved_colliding": colliding}

    def check_packed(self, confs: np.ndarray, chunk: int | None = None,
                     presort: bool | None = None) -> np.ndarray:
        """[N,6] configurations -> [N] uint8 verdict bytes (bit 0 valid,
        bit 1 coplanar, bit 2 uncertain; see ``check_poses_reference``).

        Uploads the batch once, as it stands, poses it on the device, checks
        it in one K1 launch (in launches of ``chunk`` rows, the last maybe
        short, when ``chunk`` is given) and fetches the verdict bytes once. Non-finite rows get the
        byte 0: invalid, nothing flagged (`megakernel.py:1341-1352`); the
        kernel answers them itself and counts them (``counters``), so no host
        pass tests the rows.

        ``presort`` (default off, as in the JAX package, so the main path is
        one kernel launch) first runs ``broad_block`` (the kernel's own stage
        1, bit for bit), orders broad-phase hits first and launches K1 on the
        hits alone; the rest get the byte 1 (a broad miss is valid and flags
        nothing). It costs one scalar ``.item()`` sync.
        Verdicts are identical either way (`megakernel.py:1361-1408`).

        Under a profiler each step is a span (`profiling.timers.span`):
        ``rc.check.validate`` (the array's dtype and shape), ``.upload``,
        ``.pose`` (K2), ``.kernel`` (K1, or the presorted path) and
        ``.fetch``."""
        checked = self._check_on_device(confs, chunk, presort)
        if checked is None:
            return np.zeros((0,), dtype=np.uint8)
        with span("rc.check.fetch"):
            return checked[1].cpu().numpy()

    def _check_on_device(self, confs: np.ndarray, chunk: int | None,
                         presort: bool | None):
        """``check_packed``'s steps up to its fetch: (the batch [N,6] and
        its verdict bytes [N], both on the device), or None for an empty
        batch."""
        with span("rc.check.validate"):
            confs = validate_confs(confs)
            n = confs.shape[0]
        if n == 0:
            return None
        with span("rc.check.upload"):
            dev_confs = torch.from_numpy(confs).to(self.device)
        with span("rc.check.pose"):
            poses = poses_from_confs(dev_confs)
        with span("rc.check.kernel"):
            if presort:
                packed = self._check_presorted(poses, chunk)
            else:
                packed = self._launches(poses, chunk)
        return dev_confs, packed

    def _launches(self, poses: torch.Tensor, chunk: int | None) -> torch.Tensor:
        """K1 (or its twin) over ``poses``: one launch, or launches of
        ``chunk`` rows when given."""
        step = chunk or poses.shape[0]
        outs = [check_poses(poses[lo : lo + step], self.tables, self._nonfinite)
                for lo in range(0, poses.shape[0], step)]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def check_valid(self, confs: np.ndarray, chunk: int | None = None,
                    presort: bool | None = None):
        """[N,6] configurations -> (valid[N], coplanar[N]) numpy bools: bits 0
        and 1 of ``check_packed``."""
        return valid_coplanar(self.check_packed(confs, chunk=chunk, presort=presort))

    def _check_presorted(self, poses: torch.Tensor, chunk: int | None) -> torch.Tensor:
        """Packed bytes of ``poses`` checked hits-first: the JAX package's
        `_broad_sort` (a stable partition by cumsums and one scatter) and
        `_unpermute` (`megakernel.py:1176-1206`) as torch ops, K1 launched
        on the hits alone (``_launches``). Non-finite rows count as hits (the
        broad phase reads a NaN box as a miss), so that the kernel answers
        them with the byte 0."""
        n = poses.shape[0]
        hits = mesh_broad(poses, self.tables) | _nonfinite_rows(poses, None)
        n_hit = torch.cumsum(hits, 0)
        n_miss = torch.cumsum(~hits, 0)
        dest = torch.where(hits, n_hit - 1, n_hit[-1] + n_miss - 1)
        src = torch.empty_like(dest)
        src[dest] = torch.arange(n, device=poses.device)
        k = int(n_hit[-1].item())  # the one sync: how many rows need the kernel
        packed = torch.ones((n,), dtype=torch.uint8, device=poses.device)
        if k:
            packed[:k] = self._launches(poses[src[:k]], chunk)
        return packed[dest]

    def check_valid_resolved(self, confs: np.ndarray,
                             chunk: int | None = None) -> np.ndarray:
        """[N,6] configurations -> valid[N] bool: ``check_packed``'s bytes
        with the valid rows flagged coplanar (bit 1) or uncertain (bit 2)
        re-checked in float64 on the device (`kernels.resolve`: the kernel
        of `csrc/resolve.cu` on a CUDA device, after K1 on the same stream
        and before the one fetch, or its twin on the CPU), counted in
        ``counters``. Under a profiler the call is the span ``rc.check``,
        holding ``check_packed``'s steps with ``rc.check.resolve`` (the
        resolution's issue) before ``rc.check.fetch``."""
        with span("rc.check"):
            checked = self._check_on_device(confs, chunk, None)
            if checked is None:
                return np.zeros((0,), dtype=bool)
            with span("rc.check.resolve"):
                verdicts = resolve_rows(checked[1], checked[0], self.resolve_tables,
                                        self._resolved)
            with span("rc.check.fetch"):
                return verdicts.cpu().numpy().view(bool)

    def check_block(self, confs) -> torch.Tensor:
        """[B,6] configurations (numpy, or a tensor on the checker's device)
        -> [B, OUT_COLS] int32 counter rows on the device
        (`megakernel.py:1286-1295`)."""
        confs = torch.as_tensor(confs, dtype=torch.float32, device=self.device)
        return check_poses_stats(poses_from_confs(confs), self.tables, self._nonfinite)

    def broad_block(self, confs) -> torch.Tensor:
        """[B,6] configurations -> [B] bool mesh-box overlap on the device
        (True = needs the narrow phase), bit for bit the kernel's stage-1
        broad phase (`megakernel.py:1297-1302`)."""
        confs = torch.as_tensor(confs, dtype=torch.float32, device=self.device)
        return mesh_broad(poses_from_confs(confs), self.tables)

    def check(self, confs: np.ndarray, two_phase: bool = True):
        """[N,6] configurations -> (valid, coplanar, num_pairs, broad) numpy
        arrays (`megakernel.py:1444-1491`), by `stats_columns` over
        ``broad_block`` and ``check_block``."""
        return stats_columns(confs, two_phase, lambda c: self.broad_block(c).cpu().numpy(),
                             lambda c: self.check_block(c).cpu().numpy())


def stats_columns(confs: np.ndarray, two_phase: bool, broad, rows):
    """The stats path's (valid, coplanar, num_pairs, broad) numpy arrays of
    [N,6] configurations, over a checker's ``broad(confs) -> [n] bool``
    (the kernel's stage 1) and ``rows(confs) -> [n, OUT_COLS] int32``
    (counter rows), both numpy.

    ``two_phase``: the broad phase over the whole batch first, then the
    counter rows of its survivors only; otherwise counter rows of every
    row. Non-finite rows are reported invalid, not coplanar, with 0 pairs
    and broad True."""
    confs = validate_confs(confs)
    n = confs.shape[0]
    valid = np.zeros((n,), dtype=bool)
    coplanar = np.zeros((n,), dtype=bool)
    num_pairs = np.zeros((n,), dtype=np.int32)
    broad_hit = np.ones((n,), dtype=bool)
    idx = np.flatnonzero(np.isfinite(confs).all(axis=1))
    if two_phase:
        broad_hit[idx] = broad(confs[idx])
        valid[idx] = True
        idx = idx[broad_hit[idx]]
    out = rows(confs[idx])
    valid[idx] = out[:, 0].astype(bool)
    coplanar[idx] = out[:, 1].astype(bool)
    num_pairs[idx] = out[:, 2]
    if not two_phase:
        broad_hit[idx] = out[:, 3].astype(bool)
    return valid, coplanar, num_pairs, broad_hit
