"""Batched rigid-body pose transforms (PyTorch port of
`robocheck_tpu.ops.transform`).

Pose convention: intrinsic Tait-Bryan Z-Y-X — yaw about Z, pitch about Y,
roll about X — composed as R = Rz(yaw) @ Ry(pitch) @ Rx(roll), plus a
translation (`broad-phase-fused.cu:26-55` ``createTransformationMatrix``).

Every product is an explicit elementwise multiply-add with the JAX package's
operand order. No matmul, einsum or ``@``: on the GPU a float32 matmul may
run in TF32 (about three decimal digits), which would move verdicts at the
TOL=1e-6 band, and on the CPU it reorders the sums.
"""
from __future__ import annotations

import torch

from ..core.types import CONF_PITCH, CONF_ROLL, CONF_X, CONF_YAW


def rotation_matrices(confs: torch.Tensor) -> torch.Tensor:
    """[N, 6] configurations -> [N, 3, 3] rotation matrices (float32).

    Entry formulas mirror `broad-phase-fused.cu:37-52` (A=yaw, B=pitch,
    C=roll) and `robocheck_tpu/ops/transform.py:43-51`.
    """
    pitch = confs[..., CONF_PITCH]
    yaw = confs[..., CONF_YAW]
    roll = confs[..., CONF_ROLL]

    cosB, sinB = torch.cos(pitch), torch.sin(pitch)
    cosA, sinA = torch.cos(yaw), torch.sin(yaw)
    cosC, sinC = torch.cos(roll), torch.sin(roll)

    r00 = cosA * cosB
    r01 = cosA * sinB * sinC - sinA * cosC
    r02 = cosA * sinB * cosC + sinA * sinC
    r10 = sinA * cosB
    r11 = sinA * sinB * sinC + cosA * cosC
    r12 = sinA * sinB * cosC - cosA * sinC
    r20 = -sinB
    r21 = cosB * sinC
    r22 = cosB * cosC

    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def apply_pose(R: torch.Tensor, t: torch.Tensor,
               base_vertices: torch.Tensor) -> torch.Tensor:
    """Apply rotations ``R`` [..., 3, 3] + translations ``t`` [..., 3] to
    ``base_vertices`` [V, 3] -> [..., V, 3].

    x*R[:,0] + y*R[:,1] + z*R[:,2] + t, in the multiply-add order of
    `robocheck_tpu/ops/transform.py:95` (the reference's row-major loop,
    `transform.cu:90-93`).
    """
    x = base_vertices[:, 0]  # [V]
    y = base_vertices[:, 1]
    z = base_vertices[:, 2]
    c0 = R[..., :, 0][..., None, :]  # [..., 1, 3]
    c1 = R[..., :, 1][..., None, :]
    c2 = R[..., :, 2][..., None, :]
    v = x[:, None] * c0 + y[:, None] * c1 + z[:, None] * c2
    return v + t[..., None, :]


def transform_vertices(confs: torch.Tensor,
                       base_vertices: torch.Tensor) -> torch.Tensor:
    """[N, 6] configurations, [V, 3] base vertices -> [N, V, 3] posed."""
    R = rotation_matrices(confs)
    t = confs[..., CONF_X : CONF_X + 3]
    return apply_pose(R, t, base_vertices)
