"""Driver of the clearance engine: ``ClearanceEngine(subdivide_mesh(robot,
refine).vertices, obstacle, device).min_distances(confs)``, host numpy in,
float64 distances out (the bounds phase, then K3's exact waves).

Correctness: every distance of every call in the window against the plain
float64 least point-triangle distance (`benchmark/ref/clearance.py`) over
the refined robot's points, which the reference derives again. The engine
states a sound lower bound within its error bound err = 128 float32 ulp of
the posed scene's scale (max(1, the obstacle's largest coordinate, the
batch's largest translation plus the points' largest norm)); both numbers
are in units of err: ``above_truth``, the most an answer exceeds the truth
(limit 0: sound), and ``below_truth``, the most it falls short (limit 2).

Control (``--control f32``, never in the driver's runs): the plain
reference in float32 in the program's place.
"""
from __future__ import annotations

import numpy as np
import torch

from ref.clearance import Clearance
from ref.mesh import read_obj, subdivided_vertices

UNIT = "configs"
CONTROLS = ("f32",)
_F32_EPS = float(np.finfo(np.float32).eps)


class Session:
    def __init__(self, ctx):
        from robocheck_tpu_torch import load_obj
        from robocheck_tpu_torch.planner.ccd import subdivide_mesh
        from robocheck_tpu_torch.planner.clearance import ClearanceEngine

        cfg = ctx.config
        robot = load_obj(ctx.root / cfg["robot"])
        obstacle = load_obj(ctx.root / cfg["obstacle"])
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

        return {**self.engine.stats, "k3_launches": clearance.pair_min_cuda.launches}

    def after_window(self) -> dict:
        return {}

    def close(self) -> None:
        del self.engine


def _reference(ctx, dtype) -> Clearance:
    cfg = ctx.config
    points = subdivided_vertices(*read_obj(ctx.root / cfg["robot"]), cfg["refine"])
    return Clearance(points, read_obj(ctx.root / cfg["obstacle"]), ctx.device, dtype)


def err_bound(ref: Clearance, obstacle_scale: float, confs: np.ndarray) -> float:
    """The engine's stated error bound for a batch (its docstring's rule)."""
    points = ref.points.double()
    r_max = float(torch.linalg.vector_norm(points, dim=1).max())
    scale = max(1.0, obstacle_scale,
                float(np.abs(np.asarray(confs, np.float64)[:, 0:3]).max()) + r_max)
    return 128.0 * _F32_EPS * scale


def verify(ctx, pool, calls) -> tuple[dict, dict]:
    ref = _reference(ctx, torch.float64)
    ov, ot = read_obj(ctx.root / ctx.config["obstacle"])
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
