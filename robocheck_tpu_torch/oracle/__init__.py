"""Ground-truth oracles (the FCL stand-ins).

``check_configs`` dispatches to the native C++ oracle when the shared library
is built (``make -C native``; ~40x faster) and falls back to the NumPy
float64 implementation otherwise. Both implement identical semantics —
`tests/test_native.py` diff-tests them (on the JAX package's copy).
"""
from __future__ import annotations

import numpy as np

from ..core.types import Mesh
from . import cpu_oracle


def check_configs(
    robot: Mesh, obstacle: Mesh, confs: np.ndarray, prefer_native: bool = True
) -> np.ndarray:
    """Oracle verdicts: valid[N] bool, True = collision-free."""
    if prefer_native:
        from ..runtime import native

        if native.available():
            return native.oracle_check(
                robot.vertices, robot.triangles,
                obstacle.vertices, obstacle.triangles, confs,
            )
    return cpu_oracle.check_configs(robot, obstacle, confs)


def resolve_coplanar(
    robot: Mesh, obstacle: Mesh, confs: np.ndarray,
    valid: np.ndarray, coplanar: np.ndarray,
) -> np.ndarray:
    """Exact float64 resolution of coplanar-flagged verdicts.

    The fast f32 kernels *flag* pairs whose planes coincide (the reference
    kernels printf an error there, `narrow-phase.cu:544-545`) and treat them
    as non-intersecting in the any-hit reduce — so a configuration whose
    ONLY contacts are coplanar (a robot face sliding on an obstacle face)
    reads valid=True + coplanar=True. This helper re-verdicts exactly those
    configurations with the float64 oracle, which has a true 2-D coplanar
    intersection path. Configurations already invalid stay invalid (a
    coplanar pair cannot un-collide a configuration).

    Returns a corrected copy of ``valid`` (or ``valid`` itself when nothing
    was flagged — the common case costs one boolean reduction).
    """
    fix = np.asarray(valid) & np.asarray(coplanar)
    idx = np.nonzero(fix)[0]
    if not idx.size:
        return valid
    valid = np.array(valid, copy=True)
    valid[idx] = check_configs(robot, obstacle, np.asarray(confs)[idx])
    return valid
