"""Double-precision CPU oracle — the FCL replacement.

The reference validates every GPU verdict against FCL's mesh-mesh collide
(`Utils.cu:102-161` ``checkConfsCPU``: BVH broad phase + exact triangle
tests). FCL is not available in this environment, so this module provides an
*independent* NumPy float64 implementation of the same decision — batched
rigid transform, AABB culling, and a classic Moller interval tri-tri test with
exact (tolerance-free) predicates plus a genuine coplanar 2-D path.

Independence matters: this file deliberately does NOT share code or the
reference's TOL-band semantics with `robocheck_tpu_torch.ops.narrow`, so
differential tests between the two catch implementation bugs rather than
inheriting them. Mesh-mesh "collision" here means surface intersection, the
same observable FCL's ``collide`` reports for BVHModel pairs (full containment
without surface contact is not reported — matching FCL's mesh semantics and
the reference's datasets).

Used for: tagging regenerated datasets (the 100k files are git-LFS-missing in
the reference checkout), resolving the rare coplanar pairs the fast path
flags, and fuzz-diffing the fast float32 path.
"""
from __future__ import annotations

import numpy as np

from ..core.types import Mesh


def transform_vertices_f64(conf: np.ndarray, vertices: np.ndarray) -> np.ndarray:
    """Pose a [V,3] vertex array by one (x,y,z,pitch,yaw,roll) configuration
    in float64. Convention: R = Rz(yaw) @ Ry(pitch) @ Rx(roll) + translation
    (matches `Utils.cu:88-100` / `broad-phase-fused.cu:26-55`)."""
    x, y, z, pitch, yaw, roll = [np.float64(v) for v in conf[:6]]
    ca, sa = np.cos(yaw), np.sin(yaw)
    cb, sb = np.cos(pitch), np.sin(pitch)
    cc, sc = np.cos(roll), np.sin(roll)
    R = np.array(
        [
            [ca * cb, ca * sb * sc - sa * cc, ca * sb * cc + sa * sc],
            [sa * cb, sa * sb * sc + ca * cc, sa * sb * cc - ca * sc],
            [-sb, cb * sc, cb * cc],
        ],
        dtype=np.float64,
    )
    return vertices.astype(np.float64) @ R.T + np.array([x, y, z], dtype=np.float64)


def _project_axis(D: np.ndarray) -> np.ndarray:
    """Index of the dominant |D| component, [...]."""
    return np.argmax(np.abs(D), axis=-1)


def _tri_tri_noncoplanar(t1, t2, n1, d1, n2, d2, dv1, dv2) -> np.ndarray:
    """Moller interval test for non-coplanar pairs. All args broadcast:
    t*: [...,3,3], n*: [...,3], d*: [...], dv*: [...,3]."""
    D = np.cross(n1, n2)
    axis = _project_axis(D)  # [...]
    # Simplified projection: coordinate of each corner along dominant axis.
    p1 = np.take_along_axis(t1, axis[..., None, None], axis=-1)[..., 0]  # [...,3]
    p2 = np.take_along_axis(t2, axis[..., None, None], axis=-1)[..., 0]

    def interval(p, dv):
        # Permute so corner 0 is the one alone on its side of the other plane.
        d0, d1_, d2_ = dv[..., 0], dv[..., 1], dv[..., 2]
        c2_alone = d0 * d1_ > 0  # v2 alone
        c1_alone = ~c2_alone & (d0 * d2_ > 0)  # v1 alone
        # default: v0 alone
        perm0 = np.where(c2_alone, 2, np.where(c1_alone, 1, 0))
        perm1 = np.where(c2_alone, 0, np.where(c1_alone, 0, 1))
        perm2 = np.where(c2_alone, 1, np.where(c1_alone, 2, 2))

        def take(arr, idx):
            return np.take_along_axis(arr, idx[..., None], axis=-1)[..., 0]

        pa, pb, pc = take(p, perm0), take(p, perm1), take(p, perm2)
        da, db, dc = take(dv, perm0), take(dv, perm1), take(dv, perm2)
        with np.errstate(divide="ignore", invalid="ignore"):
            ta = pa + (pb - pa) * da / (da - db)
            tb = pa + (pc - pa) * da / (da - dc)
        lo = np.minimum(ta, tb)
        hi = np.maximum(ta, tb)
        return lo, hi

    lo1, hi1 = interval(p1, dv1)
    lo2, hi2 = interval(p2, dv2)
    return ~((hi1 < lo2) | (hi2 < lo1))


def _orient2d(a, b, c) -> np.ndarray:
    """2-D orientation predicate (a,b,c: [...,2])."""
    return (b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1]) - (
        b[..., 1] - a[..., 1]
    ) * (c[..., 0] - a[..., 0])


def _segments_cross_2d(p1, p2, p3, p4) -> np.ndarray:
    d1 = _orient2d(p3, p4, p1)
    d2 = _orient2d(p3, p4, p2)
    d3 = _orient2d(p1, p2, p3)
    d4 = _orient2d(p1, p2, p4)
    proper = ((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0)) & (d1 != 0) & (
        d2 != 0
    ) & (d3 != 0) & (d4 != 0)

    def on_seg(p, q, r):
        # r collinear with pq and within its bounding box
        return (
            (np.minimum(p[..., 0], q[..., 0]) <= r[..., 0])
            & (r[..., 0] <= np.maximum(p[..., 0], q[..., 0]))
            & (np.minimum(p[..., 1], q[..., 1]) <= r[..., 1])
            & (r[..., 1] <= np.maximum(p[..., 1], q[..., 1]))
        )

    touch = (
        ((d1 == 0) & on_seg(p3, p4, p1))
        | ((d2 == 0) & on_seg(p3, p4, p2))
        | ((d3 == 0) & on_seg(p1, p2, p3))
        | ((d4 == 0) & on_seg(p1, p2, p4))
    )
    return proper | touch


def _point_in_tri_2d(pt, t) -> np.ndarray:
    """pt [...,2] inside triangle t [...,3,2] (boundary counts)."""
    o1 = _orient2d(t[..., 0, :], t[..., 1, :], pt)
    o2 = _orient2d(t[..., 1, :], t[..., 2, :], pt)
    o3 = _orient2d(t[..., 2, :], t[..., 0, :], pt)
    return ((o1 >= 0) & (o2 >= 0) & (o3 >= 0)) | ((o1 <= 0) & (o2 <= 0) & (o3 <= 0))


def _tri_tri_coplanar(t1, t2, n) -> np.ndarray:
    """2-D overlap of coplanar triangles: project out the dominant normal
    axis, then edge crossings or mutual vertex containment."""
    axis = _project_axis(n)
    keep = np.stack([(axis + 1) % 3, (axis + 2) % 3], axis=-1)  # [...,2]
    # Gather the two kept coordinates for each corner -> [...,3,2]
    def proj(t):
        return np.take_along_axis(
            t, np.broadcast_to(keep[..., None, :], t.shape[:-1] + (2,)), axis=-1
        )

    q1, q2 = proj(t1), proj(t2)
    hit = np.zeros(t1.shape[:-2], dtype=bool)
    for i in range(3):
        for j in range(3):
            hit |= _segments_cross_2d(
                q1[..., i, :], q1[..., (i + 1) % 3, :],
                q2[..., j, :], q2[..., (j + 1) % 3, :],
            )
    hit |= _point_in_tri_2d(q1[..., 0, :], q2)
    hit |= _point_in_tri_2d(q2[..., 0, :], q1)
    return hit


def tri_tri_intersect(t1: np.ndarray, t2: np.ndarray) -> np.ndarray:
    """Exact-arithmetic-style (float64, tolerance-free) triangle intersection.

    Args:
      t1, t2: [..., 3 (corner), 3 (xyz)] float64, broadcastable.
    Returns:
      bool [...].
    """
    t1 = np.asarray(t1, dtype=np.float64)
    t2 = np.asarray(t2, dtype=np.float64)
    n1 = np.cross(t1[..., 1, :] - t1[..., 0, :], t1[..., 2, :] - t1[..., 0, :])
    d1 = -np.sum(n1 * t1[..., 0, :], axis=-1)
    n2 = np.cross(t2[..., 1, :] - t2[..., 0, :], t2[..., 2, :] - t2[..., 0, :])
    d2 = -np.sum(n2 * t2[..., 0, :], axis=-1)

    dv1 = np.sum(n2[..., None, :] * t1, axis=-1) + d2[..., None]  # t1 vs plane2
    dv2 = np.sum(n1[..., None, :] * t2, axis=-1) + d1[..., None]  # t2 vs plane1

    sep1 = np.all(dv1 > 0, axis=-1) | np.all(dv1 < 0, axis=-1)
    sep2 = np.all(dv2 > 0, axis=-1) | np.all(dv2 < 0, axis=-1)

    coplanar = np.all(dv1 == 0, axis=-1)

    non_cop = _tri_tri_noncoplanar(t1, t2, n1, d1, n2, d2, dv1, dv2)
    cop = _tri_tri_coplanar(t1, t2, n1)

    return ~sep1 & ~sep2 & np.where(coplanar, cop, non_cop)


def check_configs(
    robot: Mesh,
    obstacle: Mesh,
    confs: np.ndarray,
    pair_chunk: int = 1 << 22,
    verbose: bool = False,
) -> np.ndarray:
    """Oracle verdicts for a batch of configurations.

    Returns ``valid[N]`` bool where True = collision-free (the reference's
    polarity, `Utils_rai.h:60` / `full-integration-test.cu:695`).

    Strategy (the oracle's own "BVH-lite"): whole-mesh AABB broad phase, then
    per-triangle AABB pair prefilter, then exact tri-tri on surviving pairs.
    """
    confs = np.asarray(confs, dtype=np.float64)
    n = confs.shape[0]
    valid = np.ones((n,), dtype=bool)

    obs_tri = obstacle.vertices.astype(np.float64)[obstacle.triangles]  # [To,3,3]
    obs_lo = obs_tri.min(axis=1)  # [To,3]
    obs_hi = obs_tri.max(axis=1)
    obs_mesh_lo = obs_lo.min(axis=0)
    obs_mesh_hi = obs_hi.max(axis=0)

    base_v = robot.vertices.astype(np.float64)
    tris = robot.triangles

    for i in range(n):
        rv = transform_vertices_f64(confs[i], base_v)  # [V,3]
        rob_tri = rv[tris]  # [Tr,3,3]
        rob_lo = rob_tri.min(axis=1)
        rob_hi = rob_tri.max(axis=1)

        # Mesh-level broad phase.
        if np.any(rv.min(axis=0) > obs_mesh_hi) or np.any(rv.max(axis=0) < obs_mesh_lo):
            continue  # disjoint AABBs -> no collision

        # Triangle-pair AABB prefilter.
        ov = (
            (rob_lo[:, None, :] <= obs_hi[None, :, :])
            & (obs_lo[None, :, :] <= rob_hi[:, None, :])
        ).all(axis=-1)  # [Tr,To]
        pr, po = np.nonzero(ov)
        if pr.size == 0:
            continue

        hit = False
        for s in range(0, pr.size, pair_chunk):
            sl = slice(s, s + pair_chunk)
            if tri_tri_intersect(rob_tri[pr[sl]], obs_tri[po[sl]]).any():
                hit = True
                break
        valid[i] = not hit
        if verbose and (i + 1) % 1000 == 0:
            print(f"oracle: {i + 1}/{n}")
    return valid
