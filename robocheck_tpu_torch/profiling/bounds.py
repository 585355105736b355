"""The least time an H100 could take for the fused check's work (its bound).

A kernel's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the card's memory rate, and
the operations it must do over the card's peak rate for them. Rates, from
NVIDIA's data sheet for the H100 SXM: 3.35 TB/s of HBM3 and 67
TFLOP/s of float32 outside the tensor cores, which counts a fused
multiply-add as two operations, so 33.5 T single-lane operations per second
(a multiply, an add, a compare or a min each count one; the check is built
with -fmad=false, so it fuses none). Both assume the card's full power limit
of 700 W.

The check's work depends on its data, so the count is taken from the
counter rows (`OUT_COLS`) of the same pose rows: what these inputs need.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 33.5e12
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
# Stage of the fused check -> whether it includes (gate, box tests, planes).
STAGE_WORK = {"nosweep": (True, False, False), "maskonly": (True, True, False),
              "planesonly": (True, True, True), "nodiv": (True, True, True),
              "full": (True, True, True)}


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least ms, "bytes" or "operations": whichever bounds it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
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


def probe_work(piece: str, n: int, tr: int = 1024) -> tuple[float, float]:
    """(bytes, operations) of the timed probe pieces of `chip_smoke.py` over
    ``n`` pose rows: each reads its pose rows (64 B) and writes int32 [n, 128]
    (512 B a row). mini_level3 (P1) also reads rob_base [10, tr] and poses
    every triangle of it (POSE_OPS each); pose_only (P2) computes nothing
    else; auto_invariant_vmem (P3) reads one 128-float table row and does 128
    multiplies a row."""
    io = n * (64 + 512)
    if piece == "mini_level3":
        return float(io + 4 * 10 * tr), float(n * tr * POSE_OPS)
    if piece == "pose_only":
        return float(io), 0.0
    if piece == "auto_invariant_vmem":
        return float(io + 4 * 128), float(n * 128)
    raise ValueError(f"no work model for probe piece {piece!r}")
