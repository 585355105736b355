"""Clearance queries, as the headline bench draws them (`bench.py:186-190`):
all three angles uniform in [-pi, pi], translations uniform within
``reach`` times the obstacle's extent of the centre of its box. A frozen copy
of the program's `planner/clearance.clearance_queries`.

Traffic parameters (the mix file): ``rows`` queries per batch, ``pool``
batches, ``reach``.
"""
from __future__ import annotations

import numpy as np


def batches(rng: np.random.Generator, obstacle: tuple, params: dict) -> list:
    verts = np.asarray(obstacle[0], dtype=np.float32)
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    center = np.float32(0.5) * (lo + hi)
    ext = hi - lo
    reach = params["reach"]
    out = []
    for _ in range(params["pool"]):
        n = params["rows"]
        confs = rng.uniform(-np.pi, np.pi, (n, 6)).astype(np.float32)
        confs[:, 0:3] = center + rng.uniform(-reach, reach, (n, 3)) * ext
        out.append(confs)
    return out
