"""Sequential Quadratic Programming trajectory optimizer (PyTorch port of
`robocheck_tpu.planner.sqp`).

The l1-penalty SQP formulation (TrajOpt-style) over batched collision
constraint blocks. Per outer iteration:

  1. Constraint evaluation: for every waypoint, pose the robot's surface
     samples, query the signed distance grid, and keep the top-K most
     penetrating samples -> residuals g[t,k] = margin - sdf and their
     Jacobian blocks J[t,k,6] (block-diagonal in waypoints: each residual
     depends on its own waypoint only).
  2. Convex subproblem: minimize the quadratic smoothness model plus
     mu * sum hinge(g + J dq) subject to a trust-region box |dq| <= delta,
     by projected gradient descent with a fixed iteration count.
  3. Merit test: accept dq if the true l1 merit decreased; shrink the trust
     region otherwise, grow it on good steps.
  4. Penalty escalation until the fused checker certifies the densified
     trajectory (`trajopt.densify`).

With ``mesh`` (a `parallel.sharding.ProcessMesh`) the waypoints are sharded
over its ranks: each evaluates its waypoints' blocks, the penalty total is
all-reduced and g, J are all-gathered (the subproblem consumes them
whole), and certification goes through the sharded checker.
"""
from __future__ import annotations

import concurrent.futures as _cf
import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch

from ..core.types import Mesh
from ..ops.transform import rotation_matrices
from ..runtime.device import resolve as resolve_device
from .sdf import DistanceGrid, build_distance_grid
from .trajopt import _pose_points, _sample_surface_points, densify, snap_endpoint_branch


@dataclasses.dataclass(frozen=True)
class SQPConfig:
    num_waypoints: int = 32
    max_outer: int = 30
    subproblem_iters: int = 60
    top_k: int = 8  # constraint blocks per waypoint
    margin: float = 0.3
    smooth_weight: float = 1.0
    penalty_init: float = 10.0
    penalty_growth: float = 5.0
    max_penalty_rounds: int = 5
    trust_init: float = 0.5
    trust_shrink: float = 0.5
    trust_grow: float = 1.6
    trust_max: float = 4.0
    trust_min: float = 1e-4
    rot_scale: float = 20.0
    num_surface_samples: int = 128
    grid_resolution: int = 64
    certify_step: float | None = None
    seed: int = 0
    # Periodic checkpoint of (trajectory, penalty, trust, iter) so long runs
    # survive preemption (`runtime/checkpoint.py`); None disables.
    checkpoint_path: str | None = None
    checkpoint_every: int = 10  # outer iterations between checkpoints

    def __post_init__(self):
        # Each round's speculative certification is harvested by the next
        # round's first outer iteration; a round of none would drop it
        # (the JAX package's `sqp.py:358-371`).
        if self.max_outer < 1:
            raise ValueError(f"max_outer must be at least 1, got {self.max_outer}")


class SQPResult(NamedTuple):
    trajectory: np.ndarray  # [T, 6]
    certified: bool
    outer_iters: int
    merit: float


def _pose_each(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """[..., 6] configurations x [..., 3] body points, one point each ->
    [..., 3] world points: `apply_pose`'s operations and order per point."""
    R = rotation_matrices(q)
    v = p[..., 0:1] * R[..., :, 0] + p[..., 1:2] * R[..., :, 1] + p[..., 2:3] * R[..., :, 2]
    return v + q[..., 0:3]


class _InlineExecutor:
    """``submit`` runs the call at once: certification in line, where its
    collectives must keep their order against the main thread's."""

    def submit(self, fn, *args) -> _cf.Future:
        fut = _cf.Future()
        fut.set_result(fn(*args))
        return fut

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


class SQPOptimizer:
    """``checker``: anything with ``check_valid_resolved`` (default: the
    port's `kernels.chunked.make_checker` on ``device``, the card unless the
    caller asks for the CPU). Constraint blocks, subproblem and merit run on
    ``device``; certification runs on a worker thread, overlapping the next
    penalty round's first constraint evaluation.

    ``mesh`` (a `parallel.sharding.ProcessMesh` of more than one rank, whose
    device replaces ``device``) shards the constraint blocks over the
    waypoints and the default checker over the rows. Every rank runs
    ``plan`` with the same arguments. The collectives of the blocks and of
    the checker share one process group, so certification then runs in line
    (the same results, with no overlap): from a worker thread its
    collectives could interleave with the main thread's in another order on
    each rank."""

    def __init__(self, robot: Mesh, obstacle: Mesh,
                 config: SQPConfig | None = None,
                 grid: DistanceGrid | None = None, checker=None,
                 device: torch.device | str = "cuda", mesh=None):
        from ..kernels.chunked import make_checker

        self.device = resolve_device(device)
        if mesh is not None:
            if mesh.device.type != self.device.type:
                raise ValueError(f"device {device!r} asked for on a mesh of {mesh.device}")
            self.device = mesh.device
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.robot = robot
        self.obstacle = obstacle
        self.cfg = cfg = config or SQPConfig()
        self.grid = grid if grid is not None else build_distance_grid(
            obstacle, cfg.grid_resolution, device=self.device)
        self.checker = checker or make_checker(robot, obstacle, self.device, mesh=mesh)
        self._samples = torch.from_numpy(
            _sample_surface_points(robot, cfg.num_surface_samples, cfg.seed)).to(self.device)
        rs = cfg.rot_scale
        self._scale = torch.tensor([1.0, 1.0, 1.0, rs, rs, rs], dtype=torch.float32,
                                   device=self.device)

    # -- constraint blocks --------------------------------------------------

    def _top_residuals(self, q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Every waypoint's top-K penetration residuals [T,K] (descending, as
        `lax.top_k`) and the surface samples they came from [T,K]."""
        d = self.grid.query(_pose_points(q, self._samples))  # [T,P]
        return torch.topk(self.cfg.margin - d, self.cfg.top_k, dim=-1)

    def _blocks(self, q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(g0 [T,K], J [T,K,6]) of the waypoints ``q`` (`sqp.py:110-120`),
        with J[t,k] = d g[t,k] / d q_t. Each residual is one sample's distance
        at its own waypoint, so one backward pass over the K selected
        samples, each posed by its own copy of q_t, gives every block."""
        with torch.no_grad():
            g, idx = self._top_residuals(q)
        T, K = idx.shape
        qk = q.detach()[:, None, :].expand(T, K, 6).clone().requires_grad_(True)
        with torch.enable_grad():
            gk = self.cfg.margin - self.grid.query(_pose_each(qk, self._samples[idx]))
            (J,) = torch.autograd.grad(gk.sum(), qk)
        return g, J

    def _my_waypoints(self, q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """This rank's waypoints of ``q`` padded to a multiple of the world
        size (the last row repeated, `sqp.py:204-214`) and their mask (0 on
        the padding)."""
        t, n = q.shape[0], self.mesh.size
        per = -(-t // n)
        qp = torch.cat([q, q[-1:].expand(per * n - t, 6)])
        mask = (torch.arange(per * n, device=q.device) < t).to(torch.float32)
        lo = self.mesh.rank * per
        return qp[lo : lo + per], mask[lo : lo + per]

    def _sharded_total(self, g: torch.Tensor, mask: torch.Tensor) -> float:
        local = torch.sum(torch.clamp(g, min=0.0) * mask[:, None]).reshape(1)
        return float(self.mesh.all_reduce_sum(local)[0])

    def _constraint_blocks(self, q: torch.Tensor):
        """(g0 [T,K], J [T,K,6], penalty total): waypoint-sharded, with an
        all-reduced total and all-gathered blocks, under a mesh."""
        if self.mesh is None:
            g, J = self._blocks(q)
            return g, J, float(torch.clamp(g, min=0.0).sum())
        ql, mask = self._my_waypoints(q)
        g, J = self._blocks(ql)
        t = q.shape[0]
        return (self.mesh.all_gather(g)[:t], self.mesh.all_gather(J)[:t],
                self._sharded_total(g, mask))

    @torch.no_grad()
    def _penalty_total(self, q: torch.Tensor) -> float:
        if self.mesh is None:
            return float(torch.clamp(self._top_residuals(q)[0], min=0.0).sum())
        ql, mask = self._my_waypoints(q)
        return self._sharded_total(self._top_residuals(ql)[0], mask)

    def _smooth_cost(self, q: torch.Tensor) -> torch.Tensor:
        dq = (q[1:] - q[:-1]) * self._scale
        return self.cfg.smooth_weight * torch.sum(dq * dq)

    def _merit(self, q: torch.Tensor, mu: float) -> float:
        return float(self._smooth_cost(q)) + mu * self._penalty_total(q)

    # -- subproblem ---------------------------------------------------------

    @torch.no_grad()
    def _solve_subproblem(self, q: torch.Tensor, g0: torch.Tensor, J: torch.Tensor,
                          mu: float, delta: float) -> torch.Tensor:
        """Projected gradient descent on the convexified merit in dq
        (`sqp.py:165-200`):

            model(dq) = smooth(q + dq) + mu * sum hinge(g0 + J dq),

        box |dq| <= delta, endpoints pinned by zero rows. The model's
        gradient in closed form, as reverse mode forms it: 2 w r scale
        into y[t+1] and out of y[t], with r = (y[1:] - y[:-1]) scale and
        y = q + dq, plus sum_k (mu [lin > 0]) J."""
        cfg = self.cfg
        T = q.shape[0]
        scale = self._scale
        free_mask = torch.ones((T, 1), dtype=torch.float32, device=q.device)
        free_mask[0] = 0.0
        free_mask[-1] = 0.0
        # Lipschitz-ish step: smoothness curvature ~ 4*w*scale^2.
        lr = 1.0 / (4.0 * cfg.smooth_weight * scale * scale
                    + mu * torch.sum(J * J, dim=(0, 1)) / T + 1e-6)
        two_w = 2.0 * cfg.smooth_weight
        dq = torch.zeros_like(q)
        for _ in range(cfg.subproblem_iters):
            y = q + dq
            c = two_w * ((y[1:] - y[:-1]) * scale) * scale
            grad = torch.zeros_like(q)
            grad[1:] += c
            grad[:-1] -= c
            lin = g0 + torch.sum(J * dq[:, None, :], dim=-1)
            hinge = mu * (lin > 0.0).to(torch.float32)
            grad += torch.sum(hinge[..., None] * J, dim=1)
            dq = dq - lr[None, :] * grad
            dq = torch.clamp(dq, -delta, delta) * free_mask
        return dq

    # -- certification and checkpoints --------------------------------------

    def _certify(self, traj: np.ndarray) -> bool:
        step = self.cfg.certify_step
        if step is None:
            ext = self.robot.aabb[3:] - self.robot.aabb[:3]
            step = 0.5 * float(ext.min())
        dense, _ = densify(traj, step, self.cfg.rot_scale)
        # Resolved path: coplanar contacts must fail certification.
        return bool(self.checker.check_valid_resolved(dense).all())

    def _checkpoint(self, q, mu, delta, outer, rnd) -> None:
        if self.cfg.checkpoint_path is None:
            return
        from ..runtime import checkpoint

        checkpoint.save(self.cfg.checkpoint_path, {"q": q.cpu().numpy()},
                        meta={"mu": float(mu), "delta": float(delta),
                              "outer": int(outer), "round": int(rnd)})

    def plan(self, start: np.ndarray, goal: np.ndarray,
             init: np.ndarray | None = None, resume: bool = False) -> SQPResult:
        """Plan start -> goal. With ``resume=True`` and an existing
        ``cfg.checkpoint_path``, continues from the checkpointed trajectory,
        penalty, and trust region instead of the straight-line init."""
        cfg = self.cfg
        start = np.asarray(start, np.float32)
        goal = np.asarray(goal, np.float32)
        mu = cfg.penalty_init
        delta = cfg.trust_init
        outer = 0
        start_round = 0
        if resume and cfg.checkpoint_path is not None and os.path.exists(cfg.checkpoint_path):
            from ..runtime import checkpoint

            arrays, meta = checkpoint.load(cfg.checkpoint_path)
            init = arrays["q"]
            if meta:
                mu = meta.get("mu", mu)
                delta = meta.get("delta", delta)
                outer = meta.get("outer", 0)
                start_round = meta.get("round", 0)
        if init is None:
            t = np.linspace(0, 1, cfg.num_waypoints)[:, None]
            q = ((1 - t) * start[None] + t * goal[None]).astype(np.float32)
            rng = np.random.default_rng(cfg.seed + 1)
            q[1:-1, :3] += rng.normal(scale=1e-2, size=(cfg.num_waypoints - 2, 3)
                                      ).astype(np.float32)
        else:
            q = np.asarray(init, np.float32).copy()
            # Pin endpoints on the init's 2*pi branch (trajopt.snap_endpoint_branch).
            q[0] = snap_endpoint_branch(start, q[0])
            q[-1] = snap_endpoint_branch(goal, q[-1])

        qj = torch.from_numpy(q).to(self.device)
        pending = None  # (future, traj, outer, mu, checkpoint) certification in flight
        with (_cf.ThreadPoolExecutor(max_workers=1) if self.mesh is None
              else _InlineExecutor()) as pool:
            for rnd in range(start_round, cfg.max_penalty_rounds):
                for _ in range(cfg.max_outer):
                    outer += 1
                    g0, J, tot = self._constraint_blocks(qj)
                    # Harvest the previous round's certification after this
                    # round's first constraint blocks, which it overlapped.
                    if pending is not None:
                        fut, ptraj, pouter, pmu, ckpt = pending
                        pending = None
                        if fut.result():
                            ptraj_t = torch.from_numpy(ptraj).to(self.device)
                            return SQPResult(ptraj, True, pouter, self._merit(ptraj_t, pmu))
                        # Only now that the previous round is known
                        # uncertified does its successor's checkpoint get
                        # written: a preemption during the speculative window
                        # resumes BEFORE the escalated round.
                        self._checkpoint(*ckpt)
                    dq = self._solve_subproblem(qj, g0, J, mu, delta)
                    # merit(qj) reuses the penalty total of the blocks.
                    merit_old = float(self._smooth_cost(qj)) + mu * tot
                    merit_new = self._merit(qj + dq, mu)
                    if merit_new < merit_old - 1e-9:
                        qj = qj + dq
                        delta = min(delta * cfg.trust_grow, cfg.trust_max)
                    else:
                        delta = delta * cfg.trust_shrink
                        if delta < cfg.trust_min:
                            break
                    if outer % cfg.checkpoint_every == 0:
                        self._checkpoint(qj, mu, delta, outer, rnd)
                traj = qj.cpu().numpy()
                if rnd + 1 < cfg.max_penalty_rounds:
                    # Certify on the worker and speculatively begin the next
                    # penalty round; harvested at its first iteration (above),
                    # which max_outer >= 1 guarantees. The rnd+1 checkpoint
                    # is deferred to the harvest.
                    pending = (pool.submit(self._certify, traj), traj, outer, mu,
                               (qj, mu * cfg.penalty_growth, cfg.trust_init, outer, rnd + 1))
                    mu *= cfg.penalty_growth
                    delta = cfg.trust_init
                else:
                    return SQPResult(traj, self._certify(traj), outer, self._merit(qj, mu))
        # Only a resume past the last round gets here.
        traj = qj.cpu().numpy()
        return SQPResult(traj, self._certify(traj), outer, self._merit(qj, mu))
