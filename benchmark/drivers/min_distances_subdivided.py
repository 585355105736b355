"""Driver of the clearance engine against a subdivided obstacle:
``ClearanceEngine(subdivide_mesh(robot, refine).vertices,
subdivide_mesh(obstacle, obstacle_refine), device).min_distances(confs)``,
host numpy in, float64 distances out. The same call and the same queries as
`min_distances.py` (the traffic is drawn from the unsubdivided obstacle's
box, which subdivision keeps); the obstacle's surface is cut into 4 **
``obstacle_refine`` times as many triangles.

Correctness: every distance of every call in the window against the plain
float64 least point-triangle distance of `benchmark/ref/blocked_clearance.py`,
which derives the refined robot's points and the subdivided obstacle again;
``above_truth`` (limit 0: sound) and ``below_truth`` (limit 2), in units of
the engine's stated err, by `min_distances.py`'s rule.

Control (``--control f32``, never in the driver's runs): the plain
reference in float32 in the program's place.

Counters: the engine's ``stats`` and, where the engine keeps them, its
``counters()`` (the exact phase's kept and all (pair, unit, group) scans).
"""
from __future__ import annotations

import numpy as np
import torch

from drivers.min_distances import err_bound
from ref.blocked_clearance import BlockedClearance, subdivided_mesh
from ref.mesh import read_obj, subdivided_vertices

UNIT = "configs"
CONTROLS = ("f32",)


class Session:
    def __init__(self, ctx):
        from robocheck_tpu_torch import load_obj
        from robocheck_tpu_torch.planner.ccd import subdivide_mesh
        from robocheck_tpu_torch.planner.clearance import ClearanceEngine

        cfg = ctx.config
        robot = load_obj(ctx.root / cfg["robot"])
        obstacle = subdivide_mesh(load_obj(ctx.root / cfg["obstacle"]), cfg["obstacle_refine"])
        self.engine = ClearanceEngine(subdivide_mesh(robot, cfg["refine"]).vertices, obstacle,
                                      device=ctx.device)
        self.pool = ctx.generator.batches(ctx.rng, read_obj(ctx.root / cfg["obstacle"]),
                                          ctx.traffic)
        self.control = ctx.control
        if self.control == "f32":
            ref = _reference(ctx, torch.float32)
            self.f32 = [ref.distances(b) for b in self.pool]
        for k in range(len(self.pool)):
            self.call(k)

    def units(self, k: int) -> int:
        return len(self.pool[k])

    def call(self, k: int) -> np.ndarray:
        if self.control == "f32":
            return self.f32[k]
        return self.engine.min_distances(self.pool[k])

    def counters(self) -> dict:
        from robocheck_tpu_torch.kernels import clearance

        scans = self.engine.counters() if hasattr(self.engine, "counters") else {}
        return {**self.engine.stats, **scans, "k3_launches": clearance.pair_min_cuda.launches}

    def after_window(self) -> dict:
        return {}

    def close(self) -> None:
        del self.engine


def _obstacle(ctx) -> tuple[np.ndarray, np.ndarray]:
    return subdivided_mesh(*read_obj(ctx.root / ctx.config["obstacle"]),
                           ctx.config["obstacle_refine"])


def _reference(ctx, dtype) -> BlockedClearance:
    cfg = ctx.config
    points = subdivided_vertices(*read_obj(ctx.root / cfg["robot"]), cfg["refine"])
    return BlockedClearance(points, _obstacle(ctx), ctx.device, dtype)


def verify(ctx, pool, calls) -> tuple[dict, dict]:
    ref = _reference(ctx, torch.float64)
    ov, ot = _obstacle(ctx)
    obstacle_scale = float(np.abs(ov[np.unique(ot)].astype(np.float64)).max())
    used = sorted({k for k, _ in calls})
    truth = {k: ref.distances(pool[k]) for k in used}
    err = {k: err_bound(ref, obstacle_scale, pool[k]) for k in used}
    above = below = -np.inf
    for k, answer in calls:
        answer = np.asarray(answer, dtype=np.float64)
        if answer.shape != truth[k].shape or not np.isfinite(answer).all():
            above = below = np.inf
            continue
        above = max(above, float(((answer - truth[k]) / err[k]).max()))
        below = max(below, float(((truth[k] - answer) / err[k]).max()))
    return {"above_truth": (above, 0.0), "below_truth": (below, 2.0)}, {}
