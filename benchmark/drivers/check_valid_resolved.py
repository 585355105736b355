"""Driver of the batch checker: ``MegaKernelChecker(robot, obstacle,
device).check_valid_resolved(confs)``, host numpy in, verdicts out (K2, K1
in chunks, then float64 resolution of the flagged valid rows).

Correctness: every verdict of every call in the window against the plain
float64 reference (`benchmark/ref/tritri.py`) over the call's batch, one
number, ``wrong_verdicts``, whose limit is 0. The reference's box tests
give the counts that the K1 work is charged from.

Controls (``--control``, never in the driver's runs): ``conservative`` is
the program's float32 verdict with every flagged valid row (bit 1 or 2)
taken as colliding, its float64 resolution skipped; ``broad`` is the
program's broad phase alone (K5: a row whose robot box meets the
obstacle's collides).
"""
from __future__ import annotations

import subprocess

import numpy as np
import torch

from ref.mesh import read_obj
from ref.tritri import MeshPair

UNIT = "rows"
CONTROLS = ("conservative", "broad")
# Reference rows a step on the card (its temporaries: some hundreds of MB).
REF_ROWS = {"cuda": 1024, "cpu": 64}


def _build_native(ctx) -> None:
    """The float64 oracle's library, built once into the checkout."""
    done = subprocess.run(["make", "-s", "-C", str(ctx.root / "native")],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"make -C native failed:\n{done.stdout}\n{done.stderr}")


class Session:
    def __init__(self, ctx):
        from robocheck_tpu_torch import MegaKernelChecker, load_obj

        if ctx.device == "cuda":
            _build_native(ctx)
        cfg = ctx.config
        self.robot = load_obj(ctx.root / cfg["robot"])
        self.obstacle = load_obj(ctx.root / cfg["obstacle"])
        self.checker = MegaKernelChecker(self.robot, self.obstacle, device=ctx.device)
        rob_verts, _ = read_obj(ctx.root / cfg["robot"])
        self.pool = ctx.generator.batches(ctx.rng, rob_verts, ctx.traffic)
        self.control = ctx.control
        # Warm-up: every batch once (the chunk shapes, the oracle's library).
        for k in range(len(self.pool)):
            self.call(k)

    def units(self, k: int) -> int:
        return len(self.pool[k])

    def call(self, k: int) -> np.ndarray:
        if self.control is None:
            return self.checker.check_valid_resolved(self.pool[k])
        if self.control == "broad":
            return ~self.checker.broad_block(self.pool[k]).cpu().numpy()
        packed = self.checker.check_packed(self.pool[k])
        return ((packed & 1) == 1) & ((packed & 6) == 0)

    def counters(self) -> dict:
        from robocheck_tpu_torch.kernels import front, megakernel

        return {"k1_launches": megakernel.check_poses_cuda.launches,
                "k2_launches": front.poses_from_confs_cuda.launches}

    def after_window(self) -> dict:
        """Rows that the float64 resolution takes (valid, bit 1 or 2 set),
        per batch: one ``check_packed`` call on each, outside the window."""
        flagged = []
        for batch in self.pool:
            packed = self.checker.check_packed(batch)
            flagged.append(int((((packed & 1) == 1) & ((packed & 6) != 0)).sum()))
        return {"resolve_rows": flagged}

    def close(self) -> None:
        del self.checker


def verify(ctx, pool, calls) -> tuple[dict, dict]:
    """({number: (value, limit)}, counts) of the window's answers ``calls``
    ([(batch, answer)]) against the float64 reference."""
    cfg = ctx.config
    ref = MeshPair(read_obj(ctx.root / cfg["robot"]), read_obj(ctx.root / cfg["obstacle"]),
                   ctx.device, torch.float64)
    used = sorted({k for k, _ in calls})
    counts = {"valid": {}, "pairs": {}, "broad": {}}
    for k in used:
        valid, pairs, broad = ref.check(pool[k], REF_ROWS[ctx.device])
        counts["valid"][k], counts["pairs"][k], counts["broad"][k] = valid, pairs, broad
    wrong = 0
    for k, answer in calls:
        answer = np.asarray(answer)
        if answer.shape != counts["valid"][k].shape or answer.dtype != bool:
            wrong += len(pool[k])
        else:
            wrong += int((answer != counts["valid"][k]).sum())
    robot_tris = read_obj(ctx.root / cfg["robot"])[1]
    counts["robot_vertices"] = len(np.unique(robot_tris))
    counts["robot_triangles"] = len(robot_tris)
    counts["obstacle_triangles"] = len(read_obj(ctx.root / cfg["obstacle"])[1])
    return {"wrong_verdicts": (wrong, 0)}, counts
