"""Batches of robot configurations, as the reference draws them.

A frozen copy of the generator of `Utils_rai.cu:111-136`
(``createAlphaBotConfigurations``) and `:322-348` (``generateConfs``):
translations uniform in a box scaled from the robot's extent, per axis
+-extent/200 for "hard" (compact, contact-dense) rows and +-10 x extent for
"easy" (sparse) rows, and all three angles uniform in [-pi, pi]. The extent
is taken from the robot's vertices, as the program's datagen does. Columns:
x y z pitch yaw roll, float32.

Traffic parameters (the mix file): ``rows`` per batch, ``pool`` batches,
``box``: "hard" or "easy".
"""
from __future__ import annotations

import numpy as np

SCALE = {"hard": 1.0 / 200.0, "easy": 10.0}


def uniform_confs(rng: np.random.Generator, num: int, half: np.ndarray) -> np.ndarray:
    """[num, 6] float32: xyz uniform in +-half per axis, angles in [-pi, pi]."""
    confs = np.empty((num, 6), dtype=np.float32)
    for axis in range(3):
        confs[:, axis] = rng.uniform(-half[axis], half[axis], size=num)
    confs[:, 3:6] = rng.uniform(-np.pi, np.pi, size=(num, 3))
    return confs


def batches(rng: np.random.Generator, robot_vertices: np.ndarray, params: dict) -> list:
    """``params["pool"]`` batches of ``params["rows"]`` configurations."""
    v = np.asarray(robot_vertices, dtype=np.float64)
    half = (v.max(axis=0) - v.min(axis=0)) * SCALE[params["box"]]
    return [uniform_confs(rng, params["rows"], half) for _ in range(params["pool"])]
