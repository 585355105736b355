"""Dense Moller'97 triangle-triangle intersection (PyTorch port of
`robocheck_tpu.ops.narrow`).

Every helper is a branch-free, broadcastable tensor op over whole pair sets,
with separation expressed as masks. The tolerance semantics are the
reference's, so verdicts agree with the tagged golden datasets:
  * ``isclose``: relative tolerance TOL=1e-6 with absolute-zero windows
    (`narrow-phase.cu:24-35`).
  * ``no_overlap``: the +/-TOL band with >= / <= comparisons
    (`narrow-phase.cu:93-98`).
  * the interval test uses ``>=`` (`narrow-phase.cu:658-663`).

3-vector products are written out component by component, with sums taken
left to right: no ``torch.sum``, ``linalg.cross``, einsum or matmul.

Triangles are ``[..., 3 (corner), 3 (xyz)]`` tensors; all functions
broadcast over leading dims. Where the JAX module guards a division with a
safe denominator, so does this one: such a division never makes inf or NaN.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.constants import TOL


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def isclose(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Reference relative closeness (`narrow-phase.cu:24-35`).

    both |.| < TOL -> True; exactly one < TOL -> False;
    else |(v1 - v2) / v1| < TOL  (asymmetric: divides by v1).
    """
    a1 = torch.abs(v1)
    a2 = torch.abs(v2)
    both_small = (a1 < TOL) & (a2 < TOL)
    one_small = (a1 < TOL) | (a2 < TOL)
    rel = torch.abs((v1 - v2) / torch.where(a1 < TOL, 1.0, v1)) < TOL
    return both_small | (~one_small & rel)


def iszero(v: torch.Tensor) -> torch.Tensor:
    """isclose(v, 0) simplifies to |v| < TOL."""
    return torch.abs(v) < TOL


def compute_plane(tri: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plane (N, d) with N = (v1-v0) x (v2-v1), d = -N.v0
    (`narrow-phase.cu:48-60`). tri [..., 3, 3] -> N [..., 3], d [...]."""
    e1 = tri[..., 1, :] - tri[..., 0, :]
    e2 = tri[..., 2, :] - tri[..., 1, :]
    n = _cross(e1, e2)
    return n, -_dot(n, tri[..., 0, :])


def signed_dists(n: torch.Tensor, d: torch.Tensor,
                 tri: torch.Tensor) -> torch.Tensor:
    """Signed distances [..., 3] of a triangle's corners to the plane (n, d)
    (`narrow-phase.cu:78-91`)."""
    return _dot(n[..., None, :], tri) + d[..., None]


def no_overlap(dists: torch.Tensor) -> torch.Tensor:
    """True where the triangle lies on one side of the plane, with a +/-TOL
    dead band (`narrow-phase.cu:93-98`). dists [..., 3]."""
    gz = (dists >= TOL).any(dim=-1)
    lz = (dists <= -TOL).any(dim=-1)
    return ~(gz & lz)


def la_solve(
    a1: torch.Tensor, a2: torch.Tensor, a3: torch.Tensor, a4: torch.Tensor,
    b1: torch.Tensor, b2: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve [[a1,a2],[a3,a4]] x = [b1,b2] branch-free
    (`narrow-phase.cu:109-125`): back-substitution through a2 where |a1| <
    TOL, direct elimination elsewhere; both evaluated densely, the second
    with a safe a1, and selected with ``where``."""
    a1_zero = iszero(a1)
    x2_a = b1 / a2
    x1_a = (b2 - a4 * x2_a) / a3
    denom = a2 * a3 - a1 * a4
    x2_b = (a3 * b1 - a1 * b2) / denom
    x1_b = (b1 - a2 * x2_b) / torch.where(a1_zero, 1.0, a1)
    return torch.where(a1_zero, x1_a, x1_b), torch.where(a1_zero, x2_a, x2_b)


def intersect_line(n1: torch.Tensor, d1: torch.Tensor, n2: torch.Tensor,
                   d2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Direction D [..., 3] and a point O [..., 3] of the line where two
    planes meet (`narrow-phase.cu:127-154`): the axis is chosen by the
    |D_axis| >= TOL cascade (z, then y, then x); all three solves run
    densely and ``where`` selects."""
    D = _cross(n1, n2)
    n1x, n1y, n1z = n1[..., 0], n1[..., 1], n1[..., 2]
    n2x, n2y, n2z = n2[..., 0], n2[..., 1], n2[..., 2]
    x1_z, x2_z = la_solve(n1x, n1y, n2x, n2y, -d1, -d2)  # in (x, y)
    x1_y, x2_y = la_solve(n1x, n1z, n2x, n2z, -d1, -d2)  # in (x, z)
    x1_x, x2_x = la_solve(n1y, n1z, n2y, n2z, -d1, -d2)  # in (y, z)
    use_z = ~iszero(D[..., 2])
    use_y = ~use_z & ~iszero(D[..., 1])
    zeros = torch.zeros_like(D[..., 0])
    ox = torch.where(use_z, x1_z, torch.where(use_y, x1_y, zeros))
    oy = torch.where(use_z, x2_z, torch.where(use_y, zeros, x1_x))
    oz = torch.where(use_z, zeros, torch.where(use_y, x2_y, x2_x))
    return D, torch.stack([ox, oy, oz], dim=-1)


def project_vertex(v: torch.Tensor, D: torch.Tensor,
                   O: torch.Tensor | None = None) -> torch.Tensor:
    """D . (V - O) (`narrow-phase.cu:184-190`), or the origin-free D . V when
    O is None (the origin shifts both intervals of a pair equally and cancels
    in the endpoint comparisons)."""
    return _dot(D, v if O is None else v - O)


def canonicalize(
    tri: torch.Tensor, dists: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Reorder corners so the middle one is alone on its side of the other
    triangle's plane (`narrow-phase.cu:192-236`), with strict-sign tests:

      (d0,d1 same strict sign) -> order (0, 2, 1)
      (d0,d2 same strict sign) -> order (0, 1, 2)
      otherwise               -> order (1, 0, 2)
    """
    d0, d1, d2 = dists[..., 0], dists[..., 1], dists[..., 2]
    c01 = ((d0 > 0) & (d1 > 0)) | ((d0 < 0) & (d1 < 0))
    c02 = ((d0 > 0) & (d2 > 0)) | ((d0 < 0) & (d2 < 0))

    nd0 = torch.where(c01, d0, torch.where(c02, d0, d1))
    nd1 = torch.where(c01, d2, torch.where(c02, d1, d0))
    nd2 = torch.where(c01, d1, torch.where(c02, d2, d2))

    v0, v1, v2 = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    c01v = c01[..., None]
    c02v = c02[..., None]
    nv0 = torch.where(c01v, v0, torch.where(c02v, v0, v1))
    nv1 = torch.where(c01v, v2, torch.where(c02v, v1, v0))
    nv2 = torch.where(c01v, v1, torch.where(c02v, v2, v2))
    return (torch.stack([nv0, nv1, nv2], dim=-2),
            torch.stack([nd0, nd1, nd2], dim=-1))


def parametric_t(
    v0: torch.Tensor, v1: torch.Tensor, d0: torch.Tensor, d1: torch.Tensor,
    D: torch.Tensor, O: torch.Tensor | None = None,
) -> torch.Tensor:
    """Interval endpoint t = p(v0) + (p(v1) - p(v0)) * d0 / (d0 - d1)
    (`narrow-phase.cu:238-251`), with a safe divide where d0 == d1."""
    p0 = project_vertex(v0, D, O)
    p1 = project_vertex(v1, D, O)
    dd = d0 - d1
    dd = torch.where(dd == 0.0, 1.0, dd)
    return p0 + (p1 - p0) * d0 / dd


def is_coplanar(n1: torch.Tensor, d1: torch.Tensor, n2: torch.Tensor,
                d2: torch.Tensor) -> torch.Tensor:
    """Component-ratio coplanarity test (`narrow-phase.cu:253-294`): the plane
    4-vectors (Nx, Ny, Nz, d) must be nonzero in the same components, and
    every nonzero-component ratio must ``isclose`` the first one."""
    comps = [(n1[..., 0], n2[..., 0]), (n1[..., 1], n2[..., 1]),
             (n1[..., 2], n2[..., 2]), (d1, d2)]
    z1 = [iszero(a) for a, _ in comps]
    z2 = [iszero(b) for _, b in comps]
    mismatch = (z1[0] ^ z2[0]) | (z1[1] ^ z2[1]) | (z1[2] ^ z2[2]) | (
        z1[3] ^ z2[3])
    valid = [~za & ~zb for za, zb in zip(z1, z2)]
    ratios = [a / torch.where(v, b, 1.0) for (a, b), v in zip(comps, valid)]
    ratio0 = torch.where(
        valid[0], ratios[0],
        torch.where(valid[1], ratios[1],
                    torch.where(valid[2], ratios[2], ratios[3])))
    ok = ~mismatch
    for v, r in zip(valid, ratios):
        ok = ok & (~v | isclose(ratio0, r))
    return ok


class PairResult(NamedTuple):
    collides: torch.Tensor  # bool [...]: non-coplanar Moller intersection
    coplanar: torch.Tensor  # bool [...]: pair needs the coplanar path


def pair_intersects(
    tri_r: torch.Tensor,
    tri_o: torch.Tensor,
    plane_r: tuple[torch.Tensor, torch.Tensor] | None = None,
    plane_o: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> PairResult:
    """Dense tri-tri intersection over broadcastable triangle tensors, in the
    composition of `robocheck_tpu/ops/narrow.py:252-308`: separated by either
    plane -> no hit; coplanar -> flagged; otherwise the canonical interval
    test with ``>=`` separation on the origin-free line projection."""
    n_r, d_r = plane_r if plane_r is not None else compute_plane(tri_r)
    n_o, d_o = plane_o if plane_o is not None else compute_plane(tri_o)

    dist_o = signed_dists(n_r, d_r, tri_o)  # obstacle corners vs robot plane
    sep_o = no_overlap(dist_o)
    dist_r = signed_dists(n_o, d_o, tri_r)  # robot corners vs obstacle plane
    sep_r = no_overlap(dist_r)
    coplanar = is_coplanar(n_r, d_r, n_o, d_o)

    D = _cross(n_r, n_o)
    ctri_r, cdist_r = canonicalize(tri_r, dist_r)
    ctri_o, cdist_o = canonicalize(tri_o, dist_o)

    t_r01 = parametric_t(ctri_r[..., 0, :], ctri_r[..., 1, :],
                         cdist_r[..., 0], cdist_r[..., 1], D)
    t_r12 = parametric_t(ctri_r[..., 1, :], ctri_r[..., 2, :],
                         cdist_r[..., 1], cdist_r[..., 2], D)
    t_o01 = parametric_t(ctri_o[..., 0, :], ctri_o[..., 1, :],
                         cdist_o[..., 0], cdist_o[..., 1], D)
    t_o12 = parametric_t(ctri_o[..., 1, :], ctri_o[..., 2, :],
                         cdist_o[..., 1], cdist_o[..., 2], D)

    min_r = torch.minimum(t_r01, t_r12)
    max_r = torch.maximum(t_r01, t_r12)
    min_o = torch.minimum(t_o01, t_o12)
    max_o = torch.maximum(t_o01, t_o12)
    separated_t = (min_r >= max_o) | (min_o >= max_r)

    reach = ~sep_o & ~sep_r
    return PairResult(collides=reach & ~coplanar & ~separated_t,
                      coplanar=reach & coplanar)


# ---------------------------------------------------------------------------
# Coplanar resolution: the dense form of the spec's 2-D path
# (`narrow.py:94-162` of the reference's Python spec), which the CUDA
# kernels of the reference punt on (`narrow-phase.cu:544-545`).
# ---------------------------------------------------------------------------

def _d_mnop(m, n, o, p) -> torch.Tensor:
    """(m - n) . (o - p) over the trailing xyz axis (`narrow.py:94-95`)."""
    return _dot(m - n, o - p)


def segments_intersect(p1, p2, p3, p4) -> torch.Tensor:
    """Closest-approach segment intersection test (`narrow.py:98-121`, Paul
    Bourke's mutual perpendicular), dense over leading dims; a zero
    denominator (parallel or degenerate segments) is no intersection."""
    d2121 = _d_mnop(p2, p1, p2, p1)
    d4343 = _d_mnop(p4, p3, p4, p3)
    d4321 = _d_mnop(p4, p3, p2, p1)
    d1343 = _d_mnop(p1, p3, p4, p3)
    d1321 = _d_mnop(p1, p3, p2, p1)

    mua_denom = d2121 * d4343 - d4321 * d4321
    bad_a = mua_denom == 0.0
    mua = (d1343 * d4321 - d1321 * d4343) / torch.where(bad_a, 1.0, mua_denom)
    bad_b = d4343 == 0.0
    mub = (d1343 + mua * d4321) / torch.where(bad_b, 1.0, d4343)
    in_range = (mua >= 0) & (mua <= 1) & (mub >= 0) & (mub <= 1)

    pa = p1 + mua[..., None] * (p2 - p1)
    pb = p3 + mub[..., None] * (p4 - p3)
    touch = isclose(pa, pb).all(dim=-1)
    return ~bad_a & ~bad_b & in_range & touch


def coplanar_intersects(tri_a: torch.Tensor, tri_b: torch.Tensor) -> torch.Tensor:
    """Coplanar pair intersection: any of the 9 edge pairs crossing
    (`narrow.py:123-132`) or one triangle's box inside the other's
    (`narrow.py:135-162`). tri_a, tri_b [..., 3, 3] -> bool [...]."""
    edges = [(0, 1), (0, 2), (1, 2)]
    hit = None
    for i, j in edges:
        for k, l in edges:
            h = segments_intersect(tri_a[..., i, :], tri_a[..., j, :],
                                   tri_b[..., k, :], tri_b[..., l, :])
            hit = h if hit is None else hit | h
    a_lo, a_hi = torch.amin(tri_a, dim=-2), torch.amax(tri_a, dim=-2)
    b_lo, b_hi = torch.amin(tri_b, dim=-2), torch.amax(tri_b, dim=-2)
    a_in_b = ((a_lo >= b_lo) & (a_hi <= b_hi)).all(dim=-1)
    b_in_a = ((b_lo >= a_lo) & (b_hi <= a_hi)).all(dim=-1)
    return hit | a_in_b | b_in_a
