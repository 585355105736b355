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

Beyond the copy: ``near_coplanar_pairs`` and ``touching_interval_pairs``,
single-triangle mesh pairs whose float32 verdict rounding decides, which the
CPU tests and `chip_smoke.py` hold the check and its float64 resolution to.
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


def near_coplanar_pairs(rng: np.random.Generator, n: int = 96) -> list:
    """Robot triangles R at ~300-unit coordinates, and obstacle triangles O
    through R's interior and across R's plane: O's corner c0 lies on R's
    plane in float64 (then rounded to float32), its other two corners 40
    units above that plane. Whether O straddles R's plane is decided by c0's
    signed distance, which is rounding noise in float32."""
    pairs = []
    for _ in range(n):
        r = rng.uniform(-400.0, 400.0, 3) + rng.normal(scale=120.0, size=(3, 3))
        normal = np.cross(r[1] - r[0], r[2] - r[1])
        v = normal / np.linalg.norm(normal)
        u = np.cross(v, rng.normal(size=3))
        u /= np.linalg.norm(u)
        w = rng.dirichlet(np.ones(3))
        c0 = w @ r  # on R's plane, inside R
        o = np.stack([c0, c0 + 40.0 * u + 40.0 * v, c0 - 40.0 * u + 40.0 * v])
        pairs.append((r.astype(np.float32), o.astype(np.float32)))
    return pairs


def touching_interval_pairs(rng: np.random.Generator, n: int = 128) -> list:
    """Robot triangles R at ~300-unit coordinates, and obstacle triangles O
    whose segment on R's plane starts at a point X of R's edge r0-r1, moved
    by delta (10^-6 to 10^-2 units, either sign) along R's plane away from
    R: O's corners are X + delta w, and 40 units along w on either side of
    R's plane (w the in-plane normal of the edge, pointing out of R). The
    two triangles' intervals on the line of their planes then touch, overlap
    or part by |delta|, which float32 rounding decides for the smallest
    deltas."""
    pairs = []
    for _ in range(n):
        r = rng.uniform(-400.0, 400.0, 3) + rng.normal(scale=120.0, size=(3, 3))
        v = np.cross(r[1] - r[0], r[2] - r[1])
        v /= np.linalg.norm(v)
        w = np.cross(r[1] - r[0], v)
        w /= np.linalg.norm(w)
        x = r[0] + rng.uniform(0.2, 0.8) * (r[1] - r[0])
        if w @ (r[2] - x) > 0:
            w = -w
        c0 = x + rng.choice([-1.0, 1.0]) * 10.0 ** rng.uniform(-6.0, -2.0) * w
        o = np.stack([c0, c0 + 40.0 * (v + w), c0 + 40.0 * (w - v)])
        pairs.append((r.astype(np.float32), o.astype(np.float32)))
    return pairs
