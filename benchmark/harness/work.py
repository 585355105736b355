"""The least work of the fused check (K1) and the card's peaks: the
yardstick of ``k1_roofline``.

Frozen copies of the program's constants (`profiling/bounds.py`), with the
work counted here from the window's own inputs and the plain reference's
float64 box tests, never from the kernel's counter rows. Rates from NVIDIA's
data sheet for the H100 SXM at its full 700 W: 3.35 TB/s of HBM3 and
67 TFLOP/s of float32 outside the tensor cores, every counted operation (a
multiply, an add, a compare, a min) charged as one of those.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Per distinct robot vertex of a row (a vertex that some triangle uses): its
# 3 posed coordinates at 3 multiplies and 3 adds each. A vertex that several
# triangles share is posed once.
VERTEX_OPS = 3 * 6
# Per real robot triangle of a row: its box from its posed corners (12 min /
# max) and its share of the mesh box (6).
BOX_OPS = 12 + 6
# Per box-overlapping pair of a collision-free row whose robot box meets the
# obstacle's: the robot triangle's plane (21), six signed distances (6
# each) and the two straddle tests (12 compares). A colliding row is
# charged no pair work, since a sweep may stop at its first hit.
PLANE_OPS = 21 + 6 * 6 + 12
# Bytes: a row's configuration (6 float32) in, its verdict byte out, and
# both meshes' triangles (9 float32 each) once a call.
ROW_BYTES = 6 * 4 + 1
TRIANGLE_BYTES = 9 * 4


def check_work(n_vertices: int, n_robot: int, n_obstacle: int, valid: np.ndarray,
               broad: np.ndarray, pairs: np.ndarray) -> tuple[float, float]:
    """(bytes, operations) of one call of a robot with ``n_vertices``
    distinct vertices and ``n_robot`` triangles over the rows whose
    reference verdicts, robot-box-meets-obstacle-box bits and
    box-overlapping pair counts are ``valid``, ``broad`` and ``pairs``."""
    rows = len(valid)
    free = np.asarray(valid, bool) & np.asarray(broad, bool)
    ops = (rows * (n_vertices * VERTEX_OPS + n_robot * BOX_OPS)
           + float(np.asarray(pairs, np.float64)[free].sum()) * PLANE_OPS)
    n_bytes = rows * ROW_BYTES + (n_robot + n_obstacle) * TRIANGLE_BYTES
    return float(n_bytes), float(ops)


def least_seconds(n_bytes: float, ops: float) -> float:
    """The larger of bytes over the memory rate and operations over the
    float32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
