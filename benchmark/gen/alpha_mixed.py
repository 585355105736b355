"""Batches of robot configurations that interleave the reference's hard and
easy rows 50/50, row by row: even rows are `alpha_bot`'s "hard" rows
(translations +-extent/200 per axis), odd rows its "easy" rows (+-10 x
extent), all from one generator, each row's angles uniform in [-pi, pi].

Traffic parameters (the mix file): ``rows`` per batch, ``pool`` batches.
"""
from __future__ import annotations

import numpy as np

from gen.alpha_bot import SCALE, uniform_confs


def batches(rng: np.random.Generator, robot_vertices: np.ndarray, params: dict) -> list:
    """``params["pool"]`` batches of ``params["rows"]`` configurations."""
    v = np.asarray(robot_vertices, dtype=np.float64)
    extent = v.max(axis=0) - v.min(axis=0)
    rows = params["rows"]
    out = []
    for _ in range(params["pool"]):
        confs = np.empty((rows, 6), dtype=np.float32)
        confs[0::2] = uniform_confs(rng, (rows + 1) // 2, extent * SCALE["hard"])
        confs[1::2] = uniform_confs(rng, rows // 2, extent * SCALE["easy"])
        out.append(confs)
    return out
