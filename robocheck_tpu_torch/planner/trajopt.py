"""Collision-constrained trajectory optimization (PyTorch port of
`robocheck_tpu.planner.trajopt`).

CHOMP-style penalty optimizer with exact certification:

  minimize_{q_1..q_{T-2}}   w_s * sum_t ||q_{t+1} - q_t||^2_W
                          + w_c * sum_t sum_i hinge(margin - d(x_i(q_t)))^2

where x_i(q) are posed robot surface samples and d(.) is the obstacle
distance grid (`planner/sdf.py`), differentiated by autograd and batched
over waypoints (one [T, P, 3] tensor per step). Endpoints are pinned. Each
round is a fresh Adam (optax's defaults) over the free waypoints; every
round's trajectory is certified by the fused checker, and the penalty weight
escalates until the certificate passes: gradients come from the proxy,
guarantees from the exact checker.

Also the numpy path helpers of the trajectory layer: arc-length resampling,
arc-length-adaptive densification for discrete certification, and endpoint
branch snapping.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core.types import Mesh
from ..ops.transform import apply_pose, rotation_matrices
from ..runtime.device import resolve as resolve_device
from .sdf import DistanceGrid, build_distance_grid


@dataclasses.dataclass(frozen=True)
class TrajOptConfig:
    num_waypoints: int = 32
    iters_per_round: int = 200
    max_rounds: int = 8
    lr: float = 2e-2  # Adam step size, in configuration units
    smooth_weight: float = 1.0
    collision_weight: float = 10.0
    collision_weight_growth: float = 4.0
    margin: float = 0.5
    # Rotation components move on a different scale than translation.
    rot_scale: float = 20.0
    num_surface_samples: int = 256
    grid_resolution: int = 64
    # Penalty subsamples per segment (prevents tunneling between waypoints).
    penalty_subsamples: int = 4
    # Certificate spacing: one exact check per this much translation distance
    # along each segment (None -> half the robot's smallest AABB extent).
    certify_step: float | None = None
    # Continuous certification (planner/ccd.py): prove the swept volume
    # between dense samples clear, not just the samples. Conservative: some
    # paths that are actually free cannot be certified (SweptCertifier.floor).
    swept_certify: bool = False
    swept_refine: int = 0  # surface subdivision levels for the certifier
    seed: int = 0


class TrajOptResult(NamedTuple):
    trajectory: np.ndarray  # [T, 6]
    valid: np.ndarray  # [T] bool: exact per-waypoint certificate
    certified: bool  # entire densified path collision-free (exact checker)
    rounds: int
    final_cost: float  # the last round's cost before its last Adam update
    # Continuous certificate (None unless cfg.swept_certify): a
    # planner.ccd.SweptCertificate proving the swept volume clear.
    swept: object | None = None


def resample(path: np.ndarray, num_waypoints: int,
             rot_scale: float = 20.0) -> np.ndarray:
    """Arc-length-uniform resampling of a piecewise-linear path to a fixed
    waypoint count."""
    p = path.astype(np.float64)
    w = np.array([1, 1, 1, rot_scale, rot_scale, rot_scale], np.float64)
    seg = np.sqrt((((p[1:] - p[:-1]) * w) ** 2).sum(-1))
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    total = cum[-1] if cum[-1] > 0 else 1.0
    targets = np.linspace(0.0, total, num_waypoints)
    out = np.empty((num_waypoints, 6), np.float32)
    for i, s in enumerate(targets):
        k = min(np.searchsorted(cum, s, side="right") - 1, len(seg) - 1)
        f = (s - cum[k]) / seg[k] if seg[k] > 0 else 0.0
        out[i] = p[k] + f * (p[k + 1] - p[k])
    return out


def densify(traj: np.ndarray, step: float, rot_scale: float = 20.0,
            max_per_segment: int = 4096) -> tuple[np.ndarray, np.ndarray]:
    """Arc-length-adaptive interpolation: each segment gets enough samples
    that consecutive checks are at most ``step`` apart in the weighted
    configuration metric (rotations weighted by ``rot_scale``).

    Returns (dense configs [M, 6], segment index of each dense row [M]).
    """
    t = traj.astype(np.float32)
    d = t[1:] - t[:-1]
    w = np.array([1, 1, 1, rot_scale, rot_scale, rot_scale], np.float64)
    seg_len = np.sqrt(((d.astype(np.float64) * w) ** 2).sum(-1))
    out = []
    seg_idx = []
    for i in range(len(d)):
        n = int(min(max(np.ceil(seg_len[i] / step), 1), max_per_segment))
        s = np.linspace(0.0, 1.0, n, endpoint=False)[:, None]
        out.append(t[i][None] + s * d[i][None])
        seg_idx.append(np.full(n, i, dtype=np.int64))
    out.append(t[-1:])
    seg_idx.append(np.array([len(d) - 1], dtype=np.int64))
    return np.concatenate(out, axis=0), np.concatenate(seg_idx)


def _sample_surface_points(mesh: Mesh, num: int, seed: int) -> np.ndarray:
    """Area-weighted random samples on the robot surface (the proxy queries
    these, not every vertex), numpy as in `trajopt.py:119-134`: the same seed
    gives the JAX package's points exactly."""
    tv = mesh.triangle_vertices.astype(np.float64)
    areas = 0.5 * np.linalg.norm(
        np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]), axis=1
    )
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(areas), size=num, p=areas / areas.sum())
    u = rng.random((num, 1))
    v = rng.random((num, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    pts = tv[idx, 0] + u * (tv[idx, 1] - tv[idx, 0]) + v * (tv[idx, 2] - tv[idx, 0])
    return pts.astype(np.float32)


def snap_endpoint_branch(endpoint: np.ndarray,
                         like: np.ndarray) -> np.ndarray:
    """Shift an endpoint's angle coordinates by whole turns so they land on
    the same 2*pi branch as ``like`` (an adjacent waypoint of an
    angle-continuous path, see `prm.unwrap_path`). The returned endpoint
    denotes the identical pose (angles are periodic everywhere
    downstream)."""
    e = np.asarray(endpoint, np.float64).copy()
    ref = np.asarray(like, np.float64)
    e[3:6] += 2.0 * np.pi * np.round((ref[3:6] - e[3:6]) / (2.0 * np.pi))
    return e.astype(np.float32)


def _pose_points(confs: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """[T,6] waypoints x [P,3] body points -> [T,P,3] world points, by the
    elementwise ``apply_pose`` (no matmul, so TF32 cannot enter)."""
    return apply_pose(rotation_matrices(confs), confs[:, 0:3], points)


class TrajectoryOptimizer:
    """``checker``: anything with ``check_valid_resolved`` (default: the
    port's `kernels.chunked.make_checker` on ``device``, the card unless the
    caller asks for the CPU; sharded over the ranks of ``mesh``, a
    `parallel.sharding.ProcessMesh`, when one is given). The grid, the surface samples and the Adam
    loop live on ``device``."""

    def __init__(self, robot: Mesh, obstacle: Mesh,
                 config: TrajOptConfig | None = None,
                 grid: DistanceGrid | None = None, checker=None,
                 device: torch.device | str = "cuda", mesh=None):
        from ..kernels.chunked import make_checker

        self.device = resolve_device(device)
        self.robot = robot
        self.obstacle = obstacle
        self.cfg = cfg = config or TrajOptConfig()
        self.grid = grid if grid is not None else build_distance_grid(
            obstacle, cfg.grid_resolution, device=self.device)
        self.checker = checker or make_checker(robot, obstacle, self.device, mesh=mesh)
        self._samples = torch.from_numpy(
            _sample_surface_points(robot, cfg.num_surface_samples, cfg.seed)).to(self.device)
        rs = cfg.rot_scale
        self._scale = torch.tensor([1.0, 1.0, 1.0, rs, rs, rs], dtype=torch.float32,
                                   device=self.device)
        # jnp.linspace(0, 1, k, endpoint=False) as float32 forms it: i times
        # the step 1 / k, each rounded (not i / k, rounded once).
        k = cfg.penalty_subsamples
        step = torch.tensor(1.0, dtype=torch.float32) / k
        self._s = (torch.arange(k, dtype=torch.float32) * step).to(self.device)

    def cost(self, free: torch.Tensor, endpoints: tuple, w_collision: float) -> torch.Tensor:
        """The penalty objective at ``free`` [T-2,6] between ``endpoints``
        (`trajopt.py:198-219`): smoothness of the pinned trajectory plus the
        squared grid hinge at ``penalty_subsamples`` points of every segment
        (penalising only waypoints lets the optimizer tunnel between two that
        straddle a thin obstacle)."""
        cfg, s = self.cfg, self._s
        q = torch.cat([endpoints[0][None], free, endpoints[1][None]], dim=0)
        dq = (q[1:] - q[:-1]) * self._scale
        smooth = torch.sum(dq * dq)
        qd = q[:-1, None, :] + s[None, :, None] * (q[1:, None, :] - q[:-1, None, :])  # [T-1,k,6]
        qd = torch.cat([qd.reshape(-1, 6), q[-1:, :]], dim=0)
        d = self.grid.query(_pose_points(qd, self._samples))  # [(T-1)k+1, P]
        pen = torch.clamp(cfg.margin - d, min=0.0)
        collision = torch.sum(pen * pen) / s.shape[0]
        return cfg.smooth_weight * smooth + w_collision * collision

    def adam_step(self, free: torch.Tensor, opt: torch.optim.Adam, endpoints: tuple,
                  w_collision: float) -> torch.Tensor:
        """One Adam update of the leaf ``free``; returns the cost before it."""
        opt.zero_grad(set_to_none=False)
        c = self.cost(free, endpoints, w_collision)
        c.backward()
        opt.step()
        return c.detach()

    def optimize_round(self, free: torch.Tensor, endpoints: tuple,
                       w_collision: float) -> tuple[torch.Tensor, torch.Tensor]:
        """``iters_per_round`` Adam steps from a fresh optimizer state (optax's
        state is re-initialised every round, `trajopt.py:232`). Returns the
        new free waypoints and the cost evaluated before the last update
        (optax's ``costs[-1]``), both on the device, unsynchronised."""
        cfg = self.cfg
        free = free.detach().clone().requires_grad_(True)
        opt = torch.optim.Adam([free], lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
        cost = None
        for _ in range(cfg.iters_per_round):
            cost = self.adam_step(free, opt, endpoints, w_collision)
        return free.detach(), cost

    def initial_trajectory(self, start: np.ndarray, goal: np.ndarray) -> np.ndarray:
        t = np.linspace(0.0, 1.0, self.cfg.num_waypoints)[:, None]
        return ((1 - t) * start[None] + t * goal[None]).astype(np.float32)

    def plan(self, start: np.ndarray, goal: np.ndarray,
             init: np.ndarray | None = None) -> TrajOptResult:
        """Optimize a trajectory from start to goal, escalating the collision
        penalty until the exact checker certifies every waypoint (or rounds
        run out)."""
        cfg = self.cfg
        start = np.asarray(start, np.float32)
        goal = np.asarray(goal, np.float32)
        if init is not None:
            # Angle-continuous inits (planner outputs) may end a whole turn
            # away from the raw endpoints; pin to the init's branch.
            start = snap_endpoint_branch(start, init[0])
            goal = snap_endpoint_branch(goal, init[-1])
        q = init if init is not None else self.initial_trajectory(start, goal)
        if init is None:
            # Symmetry breaking: a straight line through a symmetric obstacle
            # is a saddle of the penalty (zero lateral gradient); a tiny
            # deterministic perturbation lets descent pick a side.
            rng = np.random.default_rng(cfg.seed + 1)
            q = q.copy()
            q[1:-1, 0:3] += rng.normal(scale=1e-2, size=(q.shape[0] - 2, 3)).astype(np.float32)
        free = torch.from_numpy(np.ascontiguousarray(q[1:-1], np.float32)).to(self.device)
        endpoints = (torch.from_numpy(start).to(self.device),
                     torch.from_numpy(goal).to(self.device))

        w = cfg.collision_weight
        last_cost = np.inf
        lr_backoff = 0
        for rnd in range(cfg.max_rounds):
            new_free, cost = self.optimize_round(free, endpoints, w)
            if not bool(torch.isfinite(new_free).all()):
                # Divergence guard: keep the last finite iterate and soften
                # the penalty escalation instead of accepting garbage.
                lr_backoff += 1
                w = max(w / cfg.collision_weight_growth, 1.0)
                if lr_backoff > 2:
                    break
                continue
            free = new_free
            traj = np.concatenate([start[None], free.cpu().numpy(), goal[None]], axis=0)
            valid, certified, swept = self._certify(traj)
            last_cost = float(cost)
            if certified:
                return TrajOptResult(traj, valid, True, rnd + 1, last_cost, swept)
            w *= cfg.collision_weight_growth
        traj = np.concatenate([start[None], free.cpu().numpy(), goal[None]], axis=0)
        valid, certified, swept = self._certify(traj)
        return TrajOptResult(traj, valid, certified, cfg.max_rounds, last_cost, swept)

    def _swept_certifier(self):
        from .ccd import SweptCertifier

        if not hasattr(self, "_swept_cert"):
            # Reuse the optimizer's distance grid when it is at least as
            # fine as the certifier default (96^3): the certificate's
            # grid-error term comes from the actual grid spacing either
            # way, so any grid is sound; a finer one is just tighter.
            grid = self.grid if self.cfg.grid_resolution >= 96 else None
            self._swept_cert = SweptCertifier(self.robot, self.obstacle, grid=grid,
                                              refine=self.cfg.swept_refine, device=self.device)
        return self._swept_cert

    def _certify(self, traj: np.ndarray):
        """Exact check of the adaptively densified path (plus the optional
        continuous swept certificate); returns per-waypoint validity, the
        discrete whole-path certificate, and the SweptCertificate (or
        None)."""
        step = self.cfg.certify_step
        if step is None:
            ext = self.robot.aabb[3:] - self.robot.aabb[:3]
            step = 0.5 * float(ext.min())
        dense, seg = densify(traj, step, self.cfg.rot_scale)
        # Resolved path: coplanar contacts (face sliding on face) must fail
        # certification, not slip through as flagged-but-valid.
        dvalid = self.checker.check_valid_resolved(dense)
        # A waypoint is "valid" if every dense sample of its adjacent
        # segments is valid (conservative attribution for reporting).
        waypoint_valid = np.ones(len(traj), dtype=bool)
        for s in np.unique(seg[~dvalid]):
            waypoint_valid[s] = False
            waypoint_valid[s + 1] = False
        certified = bool(dvalid.all())
        swept = None
        if certified and self.cfg.swept_certify:
            # Continuous upgrade: prove the motion BETWEEN dense samples too;
            # a swept refutation also revokes the discrete certificate.
            swept = self._swept_certifier().certify(dense, self.checker)
            if swept.collision:
                certified = False
        return waypoint_valid, certified, swept
