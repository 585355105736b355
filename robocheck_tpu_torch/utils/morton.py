"""Morton (Z-order) triangle reordering.

Purely a host-side data-layout optimization: sorting triangles by the Morton
code of their centroids makes 128-triangle lane groups spatially coherent, so
the mega-kernel's 128x128 pair tiles are either almost-fully-overlapping or
empty — which is exactly what the tile gate (level-2 skip) wants. Verdicts
are order-independent (any-hit reduction), so this never changes results.
The reference has no analog; its warp-per-config layout couldn't exploit
spatial order (`narrow-phase.cu:601-607` iterates obstacle triangles in file
order).
"""
from __future__ import annotations

import numpy as np


def _expand_bits_3(v: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of v so there are 2 zero bits between each."""
    v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def morton_codes(points: np.ndarray) -> np.ndarray:
    """[N,3] float points -> [N] uint64 Morton codes (21 bits/axis)."""
    p = np.asarray(points, dtype=np.float64)
    lo = p.min(axis=0)
    span = p.max(axis=0) - lo
    span[span == 0] = 1.0
    q = ((p - lo) / span * ((1 << 21) - 1)).astype(np.uint64)
    return (
        (_expand_bits_3(q[:, 0]) << np.uint64(2))
        | (_expand_bits_3(q[:, 1]) << np.uint64(1))
        | _expand_bits_3(q[:, 2])
    )


def morton_argsort(points: np.ndarray) -> np.ndarray:
    """Stable permutation ordering points along the Z-order curve."""
    return np.argsort(morton_codes(points), kind="stable")
