"""Driver of the chunked batch checker against a subdivided obstacle:
``make_checker(robot, subdivide_mesh(obstacle, obstacle_refine),
device).check_valid_resolved(confs)`` with its defaults, host numpy in,
verdicts out. The pair passes one kernel block's shared memory, so the
entry point returns the Morton-chunked checker: K2, K1 and the fetch once
a chunk pair, the host combine, then the float64 resolution against the
whole pair. Set-up refuses to run where it returns anything else than the
configuration's ``chunk_pairs``.

Correctness: every verdict of every call in the window against the plain
float64 reference that scales (`benchmark/ref/blocked_tritri.py`), which
derives the subdivided obstacle again (`ref/blocked_clearance.subdivided_mesh`);
one number, ``wrong_verdicts``, whose limit is 0. The reference's box tests
give the counts that K1's least work is charged from, for the whole pair
(`check_valid_resolved.py`'s keys).

Controls (``--control``, never in the driver's runs): ``conservative`` is
the program's float32 verdict with every flagged valid row (bit 1 or 2)
taken as colliding, its float64 resolution skipped; ``broad`` is the union
of the chunk pairs' broad phases alone (a row whose robot box meets some
chunk's box collides). The plain reference in float32 reads 0 wrong on
a pool of the hard box, so it is no control here (`PERF.md` section 2).

Counters: K1's and K2's launches and, where the checker keeps them, its
``counters()`` (chunk pairs run, rows handed to them, the resolution's
rows).
"""
from __future__ import annotations

import numpy as np
import torch

from drivers import check_valid_resolved
from ref.blocked_clearance import subdivided_mesh
from ref.blocked_tritri import BlockedMeshPair
from ref.mesh import read_obj

UNIT = check_valid_resolved.UNIT
CONTROLS = check_valid_resolved.CONTROLS
# Reference rows a step (its temporaries: some GB on the card).
REF_ROWS = {"cuda": 1024, "cpu": 32}


class Session(check_valid_resolved.Session):
    """`check_valid_resolved.py`'s session (its controls, counters and
    after-window pass) over the chunked checker."""

    def __init__(self, ctx):
        from robocheck_tpu_torch import load_obj
        from robocheck_tpu_torch.kernels.chunked import ChunkedMegaKernelChecker, make_checker
        from robocheck_tpu_torch.planner.ccd import subdivide_mesh

        cfg = ctx.config
        robot = load_obj(ctx.root / cfg["robot"])
        obstacle = subdivide_mesh(load_obj(ctx.root / cfg["obstacle"]), cfg["obstacle_refine"])
        self.checker = make_checker(robot, obstacle, device=ctx.device)
        if (not isinstance(self.checker, ChunkedMegaKernelChecker)
                or self.checker.num_chunk_pairs != cfg["chunk_pairs"]):
            raise RuntimeError(f"make_checker gave {type(self.checker).__name__} with "
                               f"{getattr(self.checker, 'num_chunk_pairs', 1)} chunk pairs, "
                               f"not the chunked checker with {cfg['chunk_pairs']}")
        rob_verts, _ = read_obj(ctx.root / cfg["robot"])
        self.pool = ctx.generator.batches(ctx.rng, rob_verts, ctx.traffic)
        self.control = ctx.control
        # Warm-up: every batch once.
        for k in range(len(self.pool)):
            self.call(k)

    def call(self, k: int) -> np.ndarray:
        if self.control == "broad":
            return ~self.checker._broad_multi(self.pool[k]).any(axis=0)
        return super().call(k)

    def counters(self) -> dict:
        own = self.checker.counters() if hasattr(self.checker, "counters") else {}
        return {**super().counters(), **own}


def verify(ctx, pool, calls) -> tuple[dict, dict]:
    """({number: (value, limit)}, counts) of the window's answers ``calls``
    ([(batch, answer)]) against the float64 reference."""
    cfg = ctx.config
    ref = BlockedMeshPair(read_obj(ctx.root / cfg["robot"]),
                          subdivided_mesh(*read_obj(ctx.root / cfg["obstacle"]),
                                          cfg["obstacle_refine"]), ctx.device, torch.float64)
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
    robot_tris = ref.rob_tris.cpu().numpy()
    counts["robot_vertices"] = len(np.unique(robot_tris))
    counts["robot_triangles"] = len(robot_tris)
    counts["obstacle_triangles"] = len(ref.obs)
    return {"wrong_verdicts": (wrong, 0)}, counts
