"""Batch PRM over the fused checker (a port of `robocheck_tpu.planner.prm`).

Everything batch-shaped funnels through the checker's
``check_valid_resolved``:
  1. vertex validation: one batch of sampled configurations;
  2. edge validation: every candidate edge discretized into one batch of
     interpolated configurations (the dominant cost);
  3. graph search: Dijkstra on the host.
The host loops (kNN, the edge dict, Dijkstra) are numpy, as in the JAX
package, so the same seed gives the same roadmap wherever the checker gives
the same verdicts.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import NamedTuple

import numpy as np
import torch

from ..core.types import Mesh
from ..io.datagen import generate_confs
from .knn import conf_distance, conf_knn


@dataclasses.dataclass(frozen=True)
class PRMConfig:
    num_samples: int = 2048
    k_neighbors: int = 12
    edge_resolution: int = 16  # interpolated checks per edge
    rot_scale: float = 20.0  # rotation weight in the distance metric
    seed: int = 508


class PRMResult(NamedTuple):
    path: np.ndarray | None  # [L, 6] configurations incl. start/goal
    num_vertices: int
    num_edges_checked: int
    num_confs_checked: int
    # How far the start component reaches toward the goal under the weighted
    # metric (0.0 when a path exists).
    closest_to_goal: float = float("inf")


def unwrap_path(path: np.ndarray) -> np.ndarray:
    """Make a waypoint path's angle coordinates continuous: each consecutive
    difference is replaced by its shortest-arc equivalent, so linear
    interpolation of the returned path (`densify`, `resample`) follows the
    motion the planner validated with shortest-arc interpolation. Angles in
    the result may leave [-pi, pi]; every consumer is periodic."""
    p = np.asarray(path, np.float64).copy()
    d = p[1:, 3:6] - p[:-1, 3:6]
    d = np.arctan2(np.sin(d), np.cos(d))
    p[1:, 3:6] = p[0, 3:6] + np.cumsum(d, axis=0)
    return p.astype(np.float32)


def _interpolate(a: np.ndarray, b: np.ndarray, steps: int) -> np.ndarray:
    """Linear in translation, shortest-arc linear in each angle."""
    return _interpolate_many(a[None], b[None], steps)[0]


def _interpolate_many(a: np.ndarray, b: np.ndarray, steps: int) -> np.ndarray:
    """Batched `_interpolate`: [E,6] x [E,6] -> [E, steps, 6], one
    broadcast evaluation for the whole edge set."""
    t = np.linspace(0.0, 1.0, steps)[None, :, None]  # [1,S,1]
    a = a.astype(np.float64)[:, None, :]  # [E,1,6]
    b = b.astype(np.float64)[:, None, :]
    out = (1 - t) * a + t * b
    da = (b - a)[:, :, 3:]
    da = np.arctan2(np.sin(da), np.cos(da))
    out[:, :, 3:] = a[:, :, 3:] + t * da
    return out.astype(np.float32)


class PRMPlanner:
    """``checker``: anything with ``check_valid_resolved`` (default: the
    port's `kernels.chunked.make_checker` on ``device``, the card unless the
    caller asks for the CPU; sharded over the ranks of ``mesh``, a
    `parallel.sharding.ProcessMesh`, when one is given)."""

    def __init__(self, robot: Mesh, obstacle: Mesh,
                 config: PRMConfig | None = None, checker=None,
                 sample_box: tuple | None = None,
                 device: torch.device | str = "cuda", mesh=None):
        from ..kernels.chunked import make_checker

        self.robot = robot
        self.obstacle = obstacle
        self.cfg = config or PRMConfig()
        self.checker = checker or make_checker(robot, obstacle, device, mesh=mesh)
        if sample_box is None:
            # The obstacle box inflated by one robot extent per side.
            o = obstacle.aabb.astype(np.float64)
            r = robot.aabb.astype(np.float64)
            ext = (r[3:] - r[:3])
            lo = o[:3] - ext
            hi = o[3:] + ext
            sample_box = tuple((lo[k], hi[k]) for k in range(3))
        self.sample_box = sample_box

    def plan(self, start: np.ndarray, goal: np.ndarray) -> PRMResult:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        # Cover start and goal (plus one robot extent of slack) so queries
        # outside the obstacle's neighborhood are still connectable.
        r = self.robot.aabb.astype(np.float64)
        ext = r[3:] - r[:3]
        box = []
        for k in range(3):
            lo, hi = self.sample_box[k]
            lo = min(lo, float(start[k]) - ext[k], float(goal[k]) - ext[k])
            hi = max(hi, float(start[k]) + ext[k], float(goal[k]) + ext[k])
            box.append((lo, hi))
        samples = generate_confs(rng, cfg.num_samples, *box)
        start = np.asarray(start, np.float32)
        goal = np.asarray(goal, np.float32)
        verts = np.concatenate([start[None], goal[None], samples], axis=0)

        # 1. Vertex validation.
        valid = self.checker.check_valid_resolved(verts)
        if not (valid[0] and valid[1]):
            return PRMResult(None, 0, 0, len(verts))
        verts = verts[valid]
        n = len(verts)
        confs_checked = len(valid)

        # k-NN candidate edges under the weighted metric (chord KD-tree).
        k = min(cfg.k_neighbors, n - 1)
        nbrs, nbr_d = conf_knn(verts, k, cfg.rot_scale)
        edge_w: dict[tuple[int, int], float] = {}
        for i in range(n):
            for jj, dj in zip(nbrs[i], nbr_d[i]):
                key = (i, int(jj)) if i < jj else (int(jj), i)
                edge_w[key] = float(dj)
        edges = sorted(edge_w)

        # 2. Edge validation: one interpolation batch over all edges.
        eidx = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        interp = _interpolate_many(
            verts[eidx[:, 0]], verts[eidx[:, 1]], cfg.edge_resolution
        ).reshape(-1, 6)
        evalid = self.checker.check_valid_resolved(interp)
        confs_checked += len(interp)
        evalid = evalid.reshape(len(edges), cfg.edge_resolution).all(axis=1)

        # 3. Dijkstra on the surviving graph.
        adj: dict[int, list[tuple[int, float]]] = {i: [] for i in range(n)}
        for (i, j), ok in zip(edges, evalid):
            if ok:
                w = edge_w[(i, j)]
                adj[i].append((j, w))
                adj[j].append((i, w))

        dist = {0: 0.0}
        prev: dict[int, int] = {}
        pq = [(0.0, 0)]
        while pq:
            du, u = heapq.heappop(pq)
            if u == 1:
                break
            if du > dist.get(u, np.inf):
                continue
            for v, w in adj[u]:
                nd = du + w
                if nd < dist.get(v, np.inf):
                    dist[v] = nd
                    prev[v] = u
                    heapq.heappush(pq, (nd, v))

        if 1 not in dist:
            reached = np.fromiter(dist.keys(), dtype=np.int64)
            closest = float(conf_distance(verts[reached].astype(np.float64),
                                          verts[1].astype(np.float64),
                                          cfg.rot_scale).min())
            return PRMResult(None, n, len(edges), confs_checked, closest)
        path_idx = [1]
        while path_idx[-1] != 0:
            path_idx.append(prev[path_idx[-1]])
        path = unwrap_path(verts[path_idx[::-1]])
        return PRMResult(path, n, len(edges), confs_checked, 0.0)
