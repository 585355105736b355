"""Batched bidirectional RRT-Connect over the fused checker (a port of
`robocheck_tpu.planner.rrt`).

The tree logic stays on the host (numpy nearest neighbours over tree nodes)
and every collision-checking step is one large batch:
  * each iteration draws a batch of samples (uniform + Gaussian
    near-surface: pairs (q, q+noise) where exactly one is valid concentrate
    samples at the free-space boundary, where narrow passages are);
  * all proposed tree extensions (steer segments, discretized at
    ``edge_resolution``) are validated in one ``check_valid_resolved`` call;
  * tree-to-tree CONNECT attempts are batched the same way.
The returned path is densified and re-certified by the caller.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core.types import Mesh
from .knn import IncrementalNearest, conf_distance
from .prm import _interpolate, unwrap_path


@dataclasses.dataclass(frozen=True)
class RRTConfig:
    max_iters: int = 60          # batched iterations (not single extensions)
    batch: int = 256             # samples proposed per iteration
    step: float | None = None    # steer step (None: 0.5x robot min extent)
    edge_resolution: int = 16    # checks per steer segment
    connect_radius: float | None = None  # None: 2x step
    rot_scale: float | None = None       # None: half the robot's box diagonal
    surface_bias: float = 0.5    # fraction of samples drawn near-surface
    surface_sigma: float = 0.15  # Gaussian sigma (x robot extent)
    seed: int = 0


class RRTResult(NamedTuple):
    path: np.ndarray | None      # [K, 6] waypoints (incl. endpoints)
    num_nodes: int               # total tree nodes grown
    num_confs_checked: int
    iters: int


class RRTConnectPlanner:
    """``checker``: anything with ``check_valid_resolved`` (default: the
    port's `kernels.chunked.make_checker` on ``device``, the card unless the
    caller asks for the CPU; sharded over the ranks of ``mesh``, a
    `parallel.sharding.ProcessMesh`, when one is given)."""

    def __init__(self, robot: Mesh, obstacle: Mesh,
                 config: RRTConfig | None = None, checker=None,
                 sample_box=None, device: torch.device | str = "cuda", mesh=None):
        from ..kernels.chunked import make_checker

        self.robot = robot
        self.obstacle = obstacle
        self.cfg = config or RRTConfig()
        self.checker = checker or make_checker(robot, obstacle, device, mesh=mesh)
        r = robot.aabb.astype(np.float64)
        o = obstacle.aabb.astype(np.float64)
        ext = float((r[3:] - r[:3]).min())
        self.step = self.cfg.step if self.cfg.step is not None else 0.5 * ext
        self.connect_radius = (self.cfg.connect_radius
                               if self.cfg.connect_radius is not None
                               else 2.0 * self.step)
        self.rot_scale = (self.cfg.rot_scale if self.cfg.rot_scale is not None
                          else 0.5 * float(np.linalg.norm(r[3:] - r[:3])))
        if sample_box is None:
            # The obstacle's neighborhood inflated by the robot extent.
            lo = o[:3] - (r[3:] - r[:3])
            hi = o[3:] + (r[3:] - r[:3])
            sample_box = [(float(lo[k]), float(hi[k])) for k in range(3)]
        self.sample_box = sample_box
        self._ext = ext

    # -- sampling ----------------------------------------------------------
    def _uniform(self, rng, n):
        c = np.empty((n, 6), np.float32)
        for k in range(3):
            lo, hi = self.sample_box[k]
            c[:, k] = rng.uniform(lo, hi, n)
        c[:, 3:6] = rng.uniform(-np.pi, np.pi, (n, 3))
        return c

    def _near_surface(self, rng, n, checked):
        """Gaussian boundary sampling: of uniform pairs (q, q+noise), keep
        the one that is collision-free where exactly one is. Costs one extra
        batched check."""
        q = self._uniform(rng, n)
        noise = rng.normal(0.0, self.cfg.surface_sigma * self._ext,
                           (n, 3)).astype(np.float32)
        rnoise = rng.normal(0.0, self.cfg.surface_sigma,
                            (n, 3)).astype(np.float32)
        q2 = q.copy()
        q2[:, 0:3] += noise
        q2[:, 3:6] += rnoise
        both = np.concatenate([q, q2], axis=0)
        valid = self.checker.check_valid_resolved(both)
        checked[0] += len(both)
        v1, v2 = valid[:n], valid[n:]
        return np.concatenate([q[v1 & ~v2], q2[v2 & ~v1]], axis=0)

    def _steer(self, frm, to):
        """Move from `frm` toward `to` by at most `step` (weighted metric,
        shortest-arc in the angles)."""
        d = conf_distance(frm.astype(np.float64), to.astype(np.float64),
                          self.rot_scale)
        d = np.maximum(d, 1e-9)
        t = np.minimum(1.0, self.step / d)[..., None].astype(np.float32)
        delta = (to - frm).astype(np.float64)
        delta[:, 3:] = np.arctan2(np.sin(delta[:, 3:]), np.cos(delta[:, 3:]))
        return (frm + delta.astype(np.float32) * t).astype(np.float32)

    def plan(self, start: np.ndarray, goal: np.ndarray) -> RRTResult:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        start = np.asarray(start, np.float32)
        goal = np.asarray(goal, np.float32)
        checked = [0]

        ev = self.checker.check_valid_resolved(np.stack([start, goal]))
        checked[0] += 2
        if not (ev[0] and ev[1]):
            return RRTResult(None, 0, checked[0], 0)

        def new_tree(root):
            nn = IncrementalNearest(self.rot_scale)
            nn.add(root[None])
            return {"nodes": root[None].copy(), "parent": np.array([-1]), "nn": nn}

        trees = [new_tree(start), new_tree(goal)]

        def grow(tree, samples):
            """Batched EXTEND: steer from each sample's nearest node, check
            all steer segments in one batch, add the valid ones. Returns the
            indices of the new nodes."""
            if not len(samples):
                return np.empty((0,), np.int64)
            ni, _ = tree["nn"].nearest(samples)
            frm = tree["nodes"][ni]
            new = self._steer(frm, samples)
            segs = np.concatenate(
                [_interpolate(frm[i], new[i], cfg.edge_resolution)
                 for i in range(len(new))], axis=0)
            valid = self.checker.check_valid_resolved(segs)
            checked[0] += len(segs)
            ok = valid.reshape(len(new), cfg.edge_resolution).all(axis=1)
            keep = np.nonzero(ok)[0]
            if not len(keep):
                return np.empty((0,), np.int64)
            base = len(tree["nodes"])
            tree["nodes"] = np.concatenate([tree["nodes"], new[keep]])
            tree["parent"] = np.concatenate([tree["parent"], ni[keep]])
            tree["nn"].add(new[keep])
            return base + np.arange(len(keep), dtype=np.int64)

        def try_connect(ta, tb, new_idx):
            """Batched CONNECT: for each new node of tree a whose nearest
            node of tree b is within connect_radius, validate the joining
            segment; the first success wins."""
            if not len(new_idx):
                return None
            pts = ta["nodes"][new_idx]
            nj, dj = tb["nn"].nearest(pts)
            cand = np.nonzero(dj <= self.connect_radius)[0]
            if not len(cand):
                return None
            res = max(2, cfg.edge_resolution)
            segs = np.concatenate(
                [_interpolate(pts[i], tb["nodes"][nj[i]], res) for i in cand], axis=0)
            valid = self.checker.check_valid_resolved(segs)
            checked[0] += len(segs)
            ok = valid.reshape(len(cand), res).all(axis=1)
            hits = np.nonzero(ok)[0]
            if not len(hits):
                return None
            i = cand[hits[0]]
            return int(new_idx[i]), int(nj[i])

        def backtrace(tree, idx):
            out = []
            while idx >= 0:
                out.append(tree["nodes"][idx])
                idx = int(tree["parent"][idx])
            return out

        it = 0
        for it in range(1, cfg.max_iters + 1):
            n_surf = int(cfg.batch * cfg.surface_bias)
            samples = self._uniform(rng, cfg.batch - n_surf)
            if n_surf:
                surf = self._near_surface(rng, n_surf, checked)
                if len(surf):
                    samples = np.concatenate([samples, surf], axis=0)
            # Alternate which tree leads; both grow toward the same batch.
            a, b = (0, 1) if it % 2 else (1, 0)
            added_a = grow(trees[a], samples)
            link = try_connect(trees[a], trees[b], added_a)
            if link is None:
                added_b = grow(trees[b], trees[a]["nodes"][added_a]
                               if len(added_a) else samples)
                link_b = try_connect(trees[b], trees[a], added_b)
                if link_b is not None:
                    ib, ia = link_b
                    link = (ia, ib)
            if link is not None:
                ia, ib = link
                half_a = backtrace(trees[a], ia)[::-1]
                half_b = backtrace(trees[b], ib)
                path = np.asarray(half_a + half_b, np.float32)
                if a == 1:  # tree 0 is the start tree
                    path = path[::-1].copy()
                # Angle-continuous output (see prm.unwrap_path).
                path = unwrap_path(path)
                n_nodes = len(trees[0]["nodes"]) + len(trees[1]["nodes"])
                return RRTResult(path, n_nodes, checked[0], it)

        n_nodes = len(trees[0]["nodes"]) + len(trees[1]["nodes"])
        return RRTResult(None, n_nodes, checked[0], it)
