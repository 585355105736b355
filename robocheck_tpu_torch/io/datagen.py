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


def adversarial_confs(num: int = 65536, seed: int = 14) -> np.ndarray:
    """Finite configurations that stress the pose rows' sin / cos (not a
    reference dataset): each angle of each row drawn from one of five
    families, so every mix of them occurs: multiples of pi/4 (0, -0.0,
    +-pi/2, +-pi among them) and their float32 neighbours; uniform in
    +-1e4 rad (range reduction); uniform in +-pi; denormals and the
    smallest normals; magnitudes from 1e6 to float32's largest.
    Translations are uniform in +-1e3 with some 0, -0.0 and denormals."""
    rng = np.random.default_rng(seed)
    quarter = (np.arange(-8, 9) * (np.pi / 4)).astype(np.float32)
    special = np.concatenate([quarter, np.nextafter(quarter, np.float32(np.inf)),
                              np.nextafter(quarter, np.float32(-np.inf)),
                              np.float32([-0.0])])
    tiny = np.float32([1e-45, 1e-40, 1e-38, np.finfo(np.float32).tiny])
    tiny = np.concatenate([tiny, -tiny])
    confs = np.empty((num, 6), dtype=np.float32)
    confs[:, 0:3] = rng.uniform(-1e3, 1e3, (num, 3))
    odd = rng.random((num, 3)) < 0.05
    confs[:, 0:3][odd] = rng.choice(np.float32([0.0, -0.0, 1e-40, -1e-45]), odd.sum())
    for col in range(3, 6):
        family = rng.integers(0, 5, num)
        huge = np.float32(10.0 ** rng.uniform(6, 38, num)) * rng.choice([-1, 1], num)
        confs[:, col] = np.select(
            [family == 0, family == 1, family == 2, family == 3],
            [rng.choice(special, num), rng.uniform(-1e4, 1e4, num),
             rng.uniform(-np.pi, np.pi, num), rng.choice(tiny, num)],
            huge).astype(np.float32)
    return confs
