"""The least time an H100 could take for a kernel's work (its bound): the
fused check's, the clearance scan's, the check front end's (the pose rows,
K2, and the robot box, K5, by its vertex bound and its corner bound), the
distance grid's (K4, by its culled-work and its full-scan bound) and the
float64 resolution's.

A kernel's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the card's memory rate, and
the operations it must do over the card's peak rate for them. Rates, from
NVIDIA's data sheet for the H100 SXM: 3.35 TB/s of HBM3 and 67 TFLOP/s of
float32 outside the tensor cores (34 TFLOP/s of float64, for the
resolution, which computes in float64). That peak counts a fused
multiply-add as two operations; every operation counted here (a multiply, an add, a
compare, a min, a divide) is charged as one of those 67 T a second, so the
bound holds even where every multiply could fuse with an add. Both rates
assume the card's full power limit of 700 W.

The work of both kernels depends on their data, so it is counted from the
inputs of the run being timed: the check's from the counter rows
(`OUT_COLS`) of the same pose rows, the clearance scan's from the region
each of its distances ends in (`kernels/clearance.region_counts`), for the
culled scan only of the distances its plan takes, with its culling work.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12
# Operations per real robot triangle of a row: 9 posed coordinates at 3
# multiplies and 3 adds each, the triangle's box (12 min / max) and its
# share of the mesh box (6).
POSE_OPS = 9 * 6 + 12 + 6
# Operations per box-overlapping pair: its box test (6 compares), the robot
# triangle's plane (21), six signed distances (6 each) and the two +-TOL
# straddle tests (12 compares). The interval stage of live pairs is not
# counted (a few percent of the pairs).
BOX_OPS = 6
PLANE_OPS = 21 + 6 * 6 + 12
# Operations of one vertex-triangle distance of the clearance scan by the
# region its closest point lies in (`kernels/clearance.REGIONS`): what
# Ericson's early-exit order (Real-Time Collision Detection 5.1.5, the
# kernel's) needs there. A difference of two points costs 3, a dot product 5
# (3 multiplies, 2 adds), a region test its compares where it holds and 1
# where it fails; each distance ends with |p - q|^2 (5, plus 3 for p - q
# where q is not a corner) and the running min (1). The triangle's edges are
# the triangle's work, not the pair's.
_REACH_B = 3 + 5 + 5 + 1 + 3 + 5 + 5  # ap, d1, d2, test a fails, bp, d3, d4
_REACH_C = _REACH_B + 1 + 3 + 5 + 5  # test b fails, cp, d5, d6
_REACH_EDGES = _REACH_C + 1  # test c fails
REGION_OPS = (
    3 + 5 + 5 + 2 + 5 + 1,  # vertex a: |ap|^2
    _REACH_B + 2 + 5 + 1,  # vertex b: |bp|^2
    _REACH_C + 2 + 5 + 1,  # vertex c: |cp|^2
    _REACH_EDGES + 3 + 3 + 2 + 6 + 3 + 5 + 1,  # edge ab: vc, its test, v, q
    _REACH_EDGES + 3 + 1 + 3 + 3 + 2 + 6 + 3 + 5 + 1,  # edge ac: vb
    _REACH_EDGES + 3 + 1 + 3 + 1 + 3 + 5 + 2 + 6 + 3 + 5 + 1,  # edge bc: va, w
    _REACH_EDGES + 3 + 1 + 3 + 1 + 3 + 1 + 2 + 2 + 12 + 3 + 5 + 1,  # face: v, w, q
)
# Posing one vertex: 9 multiplies and 6 adds, and the translation (3).
POSE_VERTEX_OPS = 18
# Rotating one vertex without its translation: 9 multiplies and 6 adds. A box
# of posed vertices needs the translation once a row (6 adds to its extremes:
# rounding is monotone), not once a vertex.
ROTATE_VERTEX_OPS = 15
# The culled clearance scan's own work (`csrc/clearance.cu`): a posed
# vertex's share of its unit's box (3 min, 3 max); one box distance (per
# axis two differences, two gap selects and their sum; then 3 multiplies
# and 2 adds), which g0's choice takes for every group of a pair; and one
# cull test of a unit against a group (a box distance, its sqrt and the
# compare).
BOX_VERTEX_OPS = 6
BOX_DIST_OPS = 3 * 5 + 5
CULL_TEST_OPS = BOX_DIST_OPS + 2
# K2 (`csrc/front.cu`): per row, 21 multiplies, adds and a negation of
# sines and cosines, and six sin / cos, each charged as TRIG_OPS: about the
# float32 operations of libdevice's path for arguments below 1e5 (a
# three-part reduction, a polynomial of degree 7 to 9, the quadrant's
# selects). K2 moves 88 bytes a row, so bytes bound it whatever TRIG_OPS is.
POSE_ROW_OPS = 21
TRIG_OPS = 20
# K4 (`csrc/clearance.cu` grid_kernel), per node-triangle pair beyond its
# distance (REGION_OPS by region; the ray test's p - a is the distance's
# ap): the flat test (1); where the triangle is not flat, u (a dot product
# 5, the multiply by inv_det 1, u >= 0 1); where u >= 0, qvec (6 multiplies,
# 3 subtractions), v (5 + 1), v >= 0, u + v and its test (3); where those
# pass, t (5 + 1), t > 0 and the parity's XOR (2). Per node: the sqrt of its
# minimum (1) and, signed, the sign (1).
RAY_FLAT_OPS = 1
RAY_STAGE_OPS = (7, 18, 8)
# The float64 resolution (`csrc/resolve.cu`), per flagged row: six sin / cos
# (TRIG_OPS each) and the matrix (POSE_ROW_OPS); each robot vertex posed
# (POSE_VERTEX_OPS) with its share of the mesh box (BOX_VERTEX_OPS); each
# robot triangle's box (12 min / max); per box-overlapping pair its box test
# (BOX_OPS) and the exact test up to its separation tests: two planes (21
# each), six signed distances (6 each) and 12 compares.
RESOLVE_TRI_OPS = 12
RESOLVE_PAIR_OPS = BOX_OPS + 2 * 21 + 6 * 6 + 12
# Stage of the fused check -> whether it includes (gate, box tests, planes).
STAGE_WORK = {"nosweep": (True, False, False), "maskonly": (True, True, False),
              "planesonly": (True, True, True), "nodiv": (True, True, True),
              "full": (True, True, True)}


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """(least ms, "bytes" or "operations": whichever bounds it), the
    operations at ``ops_per_s`` (float32's peak unless given)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_work(rob_base: np.ndarray, n_obs: int, n_groups: int, counters: np.ndarray,
               stage: str = "full", out_bytes: int = 1) -> tuple[float, float]:
    """(bytes, operations) of checking the rows whose counter rows are
    ``counters`` (int [B, OUT_COLS]) against tables of ``rob_base`` [10, Tr],
    ``n_obs`` obstacle rows and ``n_groups`` group boxes, for the fused
    check's ``stage`` (a key of STAGE_WORK; "full" for the packed and counter
    instances) writing ``out_bytes`` per row.

    Bytes: the pose rows (64 B each), the four tables and the output.
    Operations: POSE_OPS per real robot triangle of every row; on broad-phase
    hits (column 3) the gate (6 compares per tile pair), then BOX_OPS and
    PLANE_OPS per box-overlapping pair (column 2) as the stage includes them.
    The box tests are counted once per box-overlapping pair: the least any
    sweep needs, not the tile pairs this kernel visits."""
    counters = np.asarray(counters, dtype=np.int64)
    b = counters.shape[0]
    tr = rob_base.shape[1]
    n_real = int((np.asarray(rob_base)[9] > 0).sum())
    n_tiles = tr // 32
    gate, box, planes = STAGE_WORK[stage]
    n_bytes = b * 64 + 4 * (rob_base.size + 20 * n_obs + 6 + 6 * n_groups) + b * out_bytes
    broad = int(counters[:, 3].sum())
    pairs = int(counters[:, 2].sum())
    n_ops = b * n_real * POSE_OPS
    n_ops += gate * broad * n_tiles * n_groups * 6
    n_ops += box * pairs * BOX_OPS + planes * pairs * PLANE_OPS
    return float(n_bytes), float(n_ops)


def resolve_work(n: int, nrv: int, nrt: int, pairs) -> tuple[float, float]:
    """(bytes, float64 operations) of the resolution over ``n`` rows, of
    which one a row of ``pairs`` is flagged, each entry the box-overlapping
    pairs that the row needs tested (all of them for a row that resolves
    collision-free, at least 1 for one that collides), against a robot of
    ``nrv`` vertices and ``nrt`` triangles. Bytes: K1's byte read and the
    verdict written a row, and a flagged row's configuration (24 B); the
    tables (a few hundred KB, read through the caches) are not counted.
    Operations: per flagged row its pose, its vertices and triangles, and
    RESOLVE_PAIR_OPS per pair; none for the other rows."""
    pairs = np.asarray(pairs, dtype=np.int64)
    f = pairs.shape[0]
    n_bytes = 2 * n + 24 * f
    per_row = (6 * TRIG_OPS + POSE_ROW_OPS + nrv * (POSE_VERTEX_OPS + BOX_VERTEX_OPS)
               + nrt * RESOLVE_TRI_OPS)
    return float(n_bytes), float(f * per_row + int(pairs.sum()) * RESOLVE_PAIR_OPS)


def pose_rows_work(n: int) -> tuple[float, float]:
    """(bytes, operations) of K2 over ``n`` configurations: 24 B read and
    64 B written a row; POSE_ROW_OPS and six TRIG_OPS a row."""
    return float(n * (24 + 64)), float(n * (POSE_ROW_OPS + 6 * TRIG_OPS))


def robot_bounds_work(rob_base: np.ndarray, n: int, hit: bool,
                      nv: int | None = None) -> tuple[float, float]:
    """(bytes, operations) of K5 over ``n`` pose rows against ``rob_base``
    [10, Tr], with the obstacle-box test where ``hit``.

    With ``nv``, the vertex bound, the least work that gives the box
    exactly: each of the robot's ``nv`` distinct real vertices (its vertex
    table, `kernels.megakernel.robot_vertices`) rotated once a row. Bytes of
    the pose rows (64 B), the vertex table (12 B a vertex), the [n,6] box
    and, with the test, the obstacle box and one byte a row;
    ROTATE_VERTEX_OPS to rotate a vertex and BOX_VERTEX_OPS to fold it into
    the row's box, 6 adds a row for the translation and 6 compares a row for
    the test. Without it, the corner bound, the posed-corner work: the
    table's bytes and POSE_OPS per real robot triangle of every row."""
    if nv is not None:
        n_bytes = n * (64 + 24) + 12 * nv + hit * (24 + n)
        n_ops = n * nv * (ROTATE_VERTEX_OPS + BOX_VERTEX_OPS) + (nv > 0) * n * 6 + hit * n * 6
        return float(n_bytes), float(n_ops)
    n_real = int((np.asarray(rob_base)[9] > 0).sum())
    n_bytes = n * (64 + 24) + 4 * np.asarray(rob_base).size + hit * (24 + n)
    return float(n_bytes), float(n * n_real * POSE_OPS + hit * n * 6)


def probe_work(piece: str, n: int, tr: int = 1024) -> tuple[float, float]:
    """(bytes, operations) of the timed probe pieces of `chip_smoke.py` over
    ``n`` pose rows: each reads its pose rows (64 B) and writes int32 [n, 128]
    (512 B a row). mini_level3 (P1) also reads rob_base [10, tr] and poses
    every triangle of it (POSE_OPS each); pose_only (P2) computes nothing
    else; of P3's pieces, auto_invariant_vmem reads one 128-float table row
    and does 128 multiplies a row, manual_dma_rob reads the whole [16, tr]
    table once and does the same multiplies, smem_invariant reads the 8 x 8
    table (256 B) once and does one multiply a row (a row holds one value)."""
    io = n * (64 + 512)
    if piece == "mini_level3":
        return float(io + 4 * 10 * tr), float(n * tr * POSE_OPS)
    if piece == "pose_only":
        return float(io), 0.0
    if piece == "auto_invariant_vmem":
        return float(io + 4 * 128), float(n * 128)
    if piece == "manual_dma_rob":
        return float(io + 4 * 16 * tr), float(n * 128)
    if piece == "smem_invariant":
        return float(io + 4 * 64), float(n)
    raise ValueError(f"no work model for probe piece {piece!r}")


def clearance_work(k: int, block: int, nt: int, blocks_read: int, regions,
                   plan=None) -> tuple[float, float]:
    """(bytes, operations) of the clearance scan over ``k`` pairs of
    ``block``-vertex blocks against ``nt`` obstacle triangles, reading
    ``blocks_read`` distinct blocks, whose distances end in each region as
    ``regions`` ([len(REGION_OPS)] counts, `kernels/clearance.region_counts`
    of the same inputs) says. Bytes: pose rows (48 B), block ids and outputs
    (4 B each) per pair, the blocks read (12 B a vertex) and the triangles
    (36 B each). Operations: POSE_VERTEX_OPS a vertex and REGION_OPS a
    distance by its region.

    With ``plan`` (`kernels/clearance.cull_plan`'s bool [k, units, ng] of
    the same inputs, ``regions`` counted under it) this is the culled
    kernel's work: also the group table (24 B of box and a flag a group),
    and for every pair that scans anything the boxes of its posed vertices
    (BOX_VERTEX_OPS a vertex), g0's choice (BOX_DIST_OPS a group; its
    distances are in ``regions``) and the cull tests (CULL_TEST_OPS a unit
    and group)."""
    n_bytes = k * (48 + 4 + 4) + blocks_read * block * 12 + nt * 36
    regions = np.asarray(regions, dtype=np.int64)
    n_ops = k * block * POSE_VERTEX_OPS + int((regions * np.asarray(REGION_OPS)).sum())
    if plan is not None:
        plan = np.asarray(plan, dtype=bool)
        _, units, ng = plan.shape
        n_bytes += ng * 25
        live = int(plan.any(axis=(1, 2)).sum())
        n_ops += live * (block * BOX_VERTEX_OPS + ng * BOX_DIST_OPS + units * ng * CULL_TEST_OPS)
    return float(n_bytes), float(n_ops)


def grid_work(nodes: int, tris: int, signed: bool, regions=None, ray=None,
              ray_pairs: int | None = None, groups: int = 0) -> tuple[float, float]:
    """(bytes, operations) of K4 over ``nodes`` grid nodes against ``tris``
    obstacle triangles, with the ray test where ``signed``.

    Bytes: the triangles' corners (36 B each), the grid (4 B a node) and,
    culled, the ``groups``' boxes, ray slacks and flags (29 B each); the
    lattice's axes (12 B per node along one axis) are left out, which only
    lowers the bound. Operations, per node-triangle pair: its distance by
    the region it ends in, REGION_OPS (from ``regions``, `kernels/sdf.grid_work_counts`'
    [len(REGION_OPS)] counts of the same inputs; without it every pair is
    charged the least region's, vertex a: 21); signed, RAY_FLAT_OPS for each
    of the ``ray_pairs`` pairs that take the ray test (every pair unless
    given) and RAY_STAGE_OPS[s] for each pair that reaches stage s (from
    ``ray``, `grid_work_counts`' [3] counts; without it every such pair is
    charged the first stage only: 1 + 7). Per node: the sqrt (1) and,
    signed, the sign (1).

    The full-scan bound counts every pair; the culled-work bound, the least
    work, the pairs of a `kernels/sdf.grid_cull_plan` (its counts, its
    ``ray_pairs`` and ``groups``). The cull's own tests and the ray-only
    pairs' p - a are left out of it, which only lowers it."""
    pairs = nodes * tris
    tested = pairs if ray_pairs is None else ray_pairs
    if regions is None:
        n_ops = pairs * min(REGION_OPS)
    else:
        n_ops = int((np.asarray(regions, dtype=np.int64) * np.asarray(REGION_OPS)).sum())
    if signed:
        stages = np.asarray([tested, 0, 0] if ray is None else ray, dtype=np.int64)
        n_ops += tested * RAY_FLAT_OPS + int((stages * np.asarray(RAY_STAGE_OPS)).sum())
    n_ops += nodes * (1 + signed)
    return float(tris * 36 + nodes * 4 + groups * 29), float(n_ops)
