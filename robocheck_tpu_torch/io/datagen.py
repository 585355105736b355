"""Benchmark dataset generation (a copy of `robocheck_tpu.io.datagen`).

Reproduces the reference generator semantics (`Utils_rai.cu:111-136`
``createAlphaBotConfigurations`` + `:322-348` ``generateConfs``): uniform
translations in a box scaled from the alpha robot's extent — "easy/sparse" =
±10× the extent per axis, "hard/compact" = ±extent/200 — and uniform rotations
in [-pi, pi] for all three angles. Tagging (ground-truth verdicts) is done by
the float64 oracle or the fused checker itself (`scripts/make_datasets.py`),
standing in for the FCL pass of `generate-tests.cu:4-46`.

The alpha-robot extents are derived from the mesh rather than hard-coded
(the reference hard-codes them, `Utils_rai.cu:113-118`).
"""
from __future__ import annotations

import numpy as np

from ..core.types import Mesh


def generate_confs(
    rng: np.random.Generator,
    num: int,
    x_range: tuple[float, float],
    y_range: tuple[float, float],
    z_range: tuple[float, float],
) -> np.ndarray:
    """Uniform configurations: xyz in the given boxes, all three angles
    uniform in [-pi, pi] (`Utils_rai.cu:322-348`)."""
    confs = np.empty((num, 6), dtype=np.float32)
    confs[:, 0] = rng.uniform(*x_range, size=num)
    confs[:, 1] = rng.uniform(*y_range, size=num)
    confs[:, 2] = rng.uniform(*z_range, size=num)
    confs[:, 3:6] = rng.uniform(-np.pi, np.pi, size=(num, 3))
    return confs


def alpha_bot_configurations(
    robot: Mesh, num: int, hard: bool, seed: int = 508
) -> np.ndarray:
    """Easy (sparse, ±10× extent) or hard (compact, ±extent/200) batches
    (`Utils_rai.cu:111-136`)."""
    lo = robot.vertices.min(axis=0).astype(np.float64)
    hi = robot.vertices.max(axis=0).astype(np.float64)
    ext = hi - lo
    scale = (1.0 / 200.0) if hard else 10.0
    rng = np.random.default_rng(seed)
    return generate_confs(
        rng,
        num,
        (-ext[0] * scale, ext[0] * scale),
        (-ext[1] * scale, ext[1] * scale),
        (-ext[2] * scale, ext[2] * scale),
    )
