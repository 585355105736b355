"""Batched point-to-mesh clearance queries on the card (PyTorch port of
`robocheck_tpu.planner.clearance`; ``ClearanceEngine`` is the counterpart of
its `TpuClearanceEngine`).

The continuous certifier (`planner/ccd.py`) needs, per configuration, the
minimum distance from any posed robot vertex to the obstacle surface. The
engine answers it to a documented, conservatively subtracted float32 error
bound, with the culling a BVH does per point done per (configuration, vertex
block) pair:

  * Robot vertices are Morton-sorted and cut into blocks of BLOCK = 1024,
    each with a body-frame box, converted to float32 conservatively. Posing
    a block's box under (R, t) is exact-conservative: center -> R c + t,
    half-extent -> |R| h.
  * Obstacle triangles are Morton-sorted and grouped (32 a group) with
    static boxes. A posed-block / group box distance lower-bounds every
    vertex-triangle distance of the pair, so LB[config, block] = min over
    groups of the box distance lower-bounds the block's contribution.
  * Upper bound U[config]: each block's representative vertex (its first
    Morton-ordered vertex) is measured exactly against every obstacle
    triangle (the scan kernel with 1-vertex blocks); U = min over them.
  * Survivors (LB - err <= best + err) run in ascending-LB waves through the
    scan kernel (`kernels/clearance.py`, `csrc/clearance.cu`), 1,024 pairs a
    launch; after each wave the tightened per-configuration best re-filters
    the rest before they run. The scatter-min into ``best`` is float64 on
    the host, as in the reference. Inside a pair the kernel also skips the
    obstacle groups whose box is farther from a unit of 128 posed vertices
    than the pair's minimum over its nearest group plus 2 x err_bound (the
    culled instance: the same float32 answer as the full scan; on the CPU
    its twin, over `cull_plan`'s scans); the representatives run the nocull
    instance. The (pair, unit, group) scans the cull keeps are counted on
    the device, beside all of them on the host (``counters``).
  * The reported distance subtracts ``err_bound`` (128 float32 ulp of the
    posed scene's scale), so it is a sound lower bound; the same slack
    guards the cull, so no pair that could hold the true minimum is dropped.

  * With ``mesh`` (a `parallel.sharding.ProcessMesh`) each exact dispatch's
    pairs are sharded over the ranks: each rank runs its contiguous slice
    through the scan kernel, and the per-pair minima are all-gathered in
    pair order, so the host scatter-min runs identically on every rank. A
    pair's minimum is the same kernel on the same inputs, so the distances
    are bit-equal to a world of 1's. The bounds phase runs on every rank
    alike.

Two faults of the reference are not carried over: the obstacle triangles
are not padded with a far-away sentinel (the kernel loops to nt, the twin
slices), and an empty vertex or triangle array raises ValueError instead of
an IndexError.
"""
from __future__ import annotations

import math
import time as _time

import numpy as np
import torch

from ..core.types import Mesh
from ..kernels.clearance import (cull_plan, make_groups, pair_min_cuda, pair_min_planned,
                                  pair_min_reference, pose_rows, tri_table, unit_vertices)
from ..ops.transform import apply_pose, rotation_matrices
from ..profiling.timers import span
from ..runtime.device import resolve as resolve_device
from ..utils.morton import morton_argsort, morton_codes

BLOCK = 1024  # robot vertices per block
TRI_CHUNK = 128  # the reference's scan step: its chunk rule for the bounds phase
PAIR_CHUNK = 1024  # (configuration, block) pairs per kernel launch
REP_PAIRS = 1 << 18  # representative pairs per launch (12 MB of pose rows)
_F32_EPS = float(np.finfo(np.float32).eps)


def _pad_to(x: np.ndarray, n: int, fill) -> np.ndarray:
    if len(x) >= n:
        return x[:n]
    pad = np.broadcast_to(fill, (n - len(x),) + x.shape[1:])
    return np.concatenate([x, pad], axis=0)


class ClearanceEngine:
    """Batched min-distance queries from a posed robot vertex set to a
    static obstacle mesh: the counterpart of `TpuClearanceEngine`.

    Args:
      robot_vertices: [V,3] body-frame vertex positions (any dtype), V > 0.
      obstacle: obstacle :class:`Mesh` with at least one triangle.
      device: "cuda" (the default: the scan kernel) or "cpu" (its twin).
      obs_group: obstacle triangles per box group.
      mesh: a `parallel.sharding.ProcessMesh` whose ranks share the exact
        phase's pairs, or None; its device must be of ``device``'s type.
    """

    def __init__(self, robot_vertices: np.ndarray, obstacle: Mesh,
                 device: torch.device | str = "cuda", obs_group: int = 32, mesh=None):
        t0 = _time.perf_counter()
        self.device = resolve_device(device)
        if mesh is not None:
            if mesh.device.type != self.device.type:
                raise ValueError(f"device {device!r} asked for on a mesh of {mesh.device}")
            self.device = mesh.device
        self.mesh = mesh
        self._events = []  # (phase, start, end): CUDA events of launches not yet read
        v = np.asarray(robot_vertices, dtype=np.float64).reshape(-1, 3)
        tri = np.asarray(obstacle.triangle_vertices, dtype=np.float64)
        if len(v) == 0:
            raise ValueError("the robot has no vertices: no clearance to measure")
        if len(tri) == 0:
            raise ValueError("the obstacle has no triangles: no clearance to measure")

        def put(a):  # float64 host array -> float32 tensor on the device
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float32)).to(self.device)

        # Non-stable argsort, as the reference (ties in Morton code carry no
        # meaning for blocking).
        v = v[np.argsort(morton_codes(v))]
        self.num_vertices = len(v)
        nb = math.ceil(len(v) / BLOCK)
        vp = _pad_to(v, nb * BLOCK, v[-1]).reshape(nb, BLOCK, 3)
        self.num_blocks = nb
        lo, hi = vp.min(axis=1), vp.max(axis=1)
        cent, half = (lo + hi) / 2.0, (hi - lo) / 2.0
        # The float32 box must stay conservative: inflate the half-extent by
        # what the center / half conversions can lose.
        infl = np.maximum(np.abs(cent), half) * (4 * _F32_EPS) + 1e-12
        self._bcent = put(cent)
        self._bhalf = put(half + infl)
        self._blocks = put(vp)
        self._reps = self._blocks[:, 0:1, :].contiguous()  # [nb, 1, 3]

        tri = tri[morton_argsort(tri.mean(axis=1))]
        nt = len(tri)
        self._tris = put(tri.reshape(nt, 9))
        self._tab = tri_table(self._tris)  # corners and edges, once for every launch
        # Group boxes (the reference's `_glo` / `_ghi`) and always-scan flags.
        self._groups = make_groups(self._tris, obs_group)
        self._glo, self._ghi = self._groups.boxes[:, 0:3], self._groups.boxes[:, 3:6]
        self.num_groups = self._groups.boxes.shape[0]
        self.num_triangles = nt

        # The exact phase's (pair, unit, group) scans: those the cull kept,
        # added on the device by the kernel (or `cull_plan`'s on the CPU),
        # and all of them, on the host; read only by ``counters``.
        self._kept = torch.zeros((), dtype=torch.int64, device=self.device)
        self._scans = 0

        self._obs_scale = float(np.abs(tri).max())
        # The max vertex 2-norm, not the max coordinate: a rotation can align
        # a vertex's norm with one axis, so the posed coordinate bound is
        # ||v||_2 + |t|.
        self._r_max_abs = float(np.sqrt((v * v).sum(axis=1).max()))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the tables are on the card
        # Accounting (certify_multires' verbose report, phase 9 of
        # chip_smoke.py, scripts/torch_certify_alpha.py): host-clock seconds
        # of construction and of each phase, and kernel_s, the device
        # seconds of the scan kernel's launches (CUDA events around each;
        # 0.0 on the CPU, where the twin runs), the sum of rep_kernel_s
        # (the representatives) and exact_kernel_s (the exact phase); waves,
        # the exact phase's dispatches (one fetch each).
        self.stats = {"construct_s": _time.perf_counter() - t0,
                      "bounds_s": 0.0, "exact_s": 0.0, "kernel_s": 0.0, "rep_kernel_s": 0.0,
                      "exact_kernel_s": 0.0, "pairs": 0, "waves": 0, "configs": 0,
                      "calls": 0}

    def counters(self) -> dict:
        """{"scans_kept": the (pair, vertex unit, obstacle group) scans that
        the exact phase's culled launches kept (`cull_plan`'s), "scans": all
        such scans of those launches} since the engine was made. One device
        read; no call makes it."""
        return {"scans_kept": int(self._kept.item()), "scans": self._scans}

    # -- error model --------------------------------------------------------
    def err_bound(self, confs: np.ndarray) -> float:
        """Conservative absolute float32 error on any distance this engine
        computes for ``confs`` (`clearance.py:237-249`): 128 ulp of the
        largest coordinate magnitude in the posed scene. The constant is
        empirical; `chip_smoke.py` phase 9 measures the worst deviation from
        the float64 BVH on the card."""
        c = np.asarray(confs, dtype=np.float64)
        scale = max(1.0, self._obs_scale,
                    float(np.abs(c[:, 0:3]).max(initial=0.0)) + self._r_max_abs)
        return 128.0 * _F32_EPS * scale

    # -- device phases ------------------------------------------------------
    def _scan(self, phase: str, rows: torch.Tensor, ids: torch.Tensor, table: torch.Tensor,
              slack: float | None = None) -> torch.Tensor:
        """One launch of the scan over ``table``'s blocks for ``phase``
        ("rep" or "exact"), culled with ``slack`` where one is given (the
        twins on the CPU, the same distances), its kept scans counted; on
        the card it is timed by CUDA events, read by ``_fetch``."""
        if slack is not None:
            block = table.shape[1]
            self._scans += len(ids) * -(-block // unit_vertices(block)) * self.num_groups
        if self.device.type != "cuda":
            if slack is None:
                return pair_min_reference(rows, ids, table, self._tris)
            plan = cull_plan(rows, ids, table, self._tris, self._groups, slack)
            self._kept += plan.sum()
            return pair_min_planned(rows, ids, table, self._tris, plan, self._groups.size)
        stream = torch.cuda.current_stream(self.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = pair_min_cuda(rows, ids, table, self._tab,
                            None if slack is None else self._groups, slack or 0.0,
                            kept=None if slack is None else self._kept)
        end.record(stream)
        self._events.append((phase, start, end))
        return out

    def _fetch(self, outs: list) -> np.ndarray:
        """The launches' outputs, concatenated, as float64 on the host; adds
        their device time to ``stats["kernel_s"]`` and their phase's (the
        fetch waits for them)."""
        with span("rc.clearance.fetch"):
            d = torch.cat(outs).cpu().numpy().astype(np.float64)
            for phase, s, e in self._events:
                sec = s.elapsed_time(e) / 1e3
                self.stats["kernel_s"] += sec
                self.stats[f"{phase}_kernel_s"] += sec
            self._events.clear()
            return d

    def _bounds(self, confs: torch.Tensor, rows: torch.Tensor):
        """(LB, Drep) [b, nb] float64 on the host: the posed-block / group
        box lower bound of every pair and each representative vertex's exact
        distance, in configuration chunks that keep the [cc, nb, max(ng,
        TRI_CHUNK)] temporaries of the reference's rule near 8 MB. The
        representatives' launches and their fetch are the span
        ``rc.clearance.reps``; the bounds' fetch follows it."""
        b, nb = confs.shape[0], self.num_blocks
        cc = max(1, (1 << 21) // max(nb * max(self.num_groups, TRI_CHUNK), 1))
        lbs = []
        for lo in range(0, b, cc):
            part = confs[lo : lo + cc]
            Rc, tc = rotation_matrices(part), part[:, 0:3]
            c = apply_pose(Rc, tc, self._bcent)  # [cc, nb, 3]
            h = apply_pose(Rc.abs(), torch.zeros_like(tc), self._bhalf)
            blo = (c - h)[:, :, None, :]  # [cc, nb, 1, 3]
            bhi = (c + h)[:, :, None, :]
            gap = (torch.clamp(self._glo[None, None] - bhi, min=0.0)
                   + torch.clamp(blo - self._ghi[None, None], min=0.0))
            d = torch.sqrt((gap[..., 0] * gap[..., 0] + gap[..., 1] * gap[..., 1])
                           + gap[..., 2] * gap[..., 2])
            lbs.append(d.amin(dim=-1))
        lb = torch.cat(lbs)
        # The representatives as 1-vertex blocks, one pair per (configuration,
        # block), up to REP_PAIRS pairs (their pose rows) a launch.
        with span("rc.clearance.reps"):
            block_ids = torch.arange(nb, dtype=torch.int32, device=self.device)
            cr = max(1, REP_PAIRS // nb)
            reps = [self._scan("rep", rows[lo : lo + cr].repeat_interleave(nb, dim=0),
                               block_ids.repeat(min(cr, b - lo)), self._reps)
                    for lo in range(0, b, cr)]
            drep = self._fetch(reps).reshape(b, nb)
        return lb.cpu().numpy().astype(np.float64), drep

    def _run_pairs(self, rows: torch.Tensor, cfg_ids: np.ndarray, blk_ids: np.ndarray,
                   best: np.ndarray, err: float) -> None:
        """Exact distances of (configuration, block) pairs, PAIR_CHUNK a
        launch, all launched before one fetch, culled with slack 2 x ``err``;
        scatter-min into ``best`` (float64, in place, on the host). A call
        with pairs is one wave (``stats["waves"]``)."""
        if len(cfg_ids) == 0:
            return
        self.stats["waves"] += 1
        with span("rc.clearance.exact"):
            t0 = _time.perf_counter()
            k = len(cfg_ids)
            mine = slice(None)
            if self.mesh is not None and self.mesh.size > 1:
                # This rank's contiguous slice of the pairs, padded so that the
                # slices are equal (the padding repeats pair 0 and is dropped).
                per = -(-k // self.mesh.size)
                mine = slice(self.mesh.rank * per, (self.mesh.rank + 1) * per)
                pad = per * self.mesh.size - k
                cfg_ids = np.concatenate([cfg_ids, np.repeat(cfg_ids[:1], pad)])
                blk_ids = np.concatenate([blk_ids, np.repeat(blk_ids[:1], pad)])
            ci = torch.as_tensor(cfg_ids[mine]).to(self.device)
            bi = torch.as_tensor(blk_ids[mine].astype(np.int32)).to(self.device)
            outs = [self._scan("exact", rows[ci[lo : lo + PAIR_CHUNK]],
                               bi[lo : lo + PAIR_CHUNK], self._blocks, 2.0 * err)
                    for lo in range(0, len(ci), PAIR_CHUNK)]
            d = self._fetch(outs)
            if self.mesh is not None and self.mesh.size > 1:
                d = self.mesh.all_gather(torch.from_numpy(d)).numpy()[:k]
            with span("rc.clearance.scatter"):
                np.minimum.at(best, cfg_ids[:k], d)
            self.stats["exact_s"] += _time.perf_counter() - t0
        self.stats["pairs"] += k

    def _survivors(self, confs: torch.Tensor, rows: torch.Tensor, best: np.ndarray,
                   err: float):
        """Phase 1: box lower bounds and representative-vertex distances;
        ``best`` (in place) starts at U (attained distances). Returns the
        surviving pairs' configurations, blocks and lower bounds in
        ascending-LB order: the exact phase's launch order."""
        with span("rc.clearance.bounds"):
            t0 = _time.perf_counter()
            lb, drep = self._bounds(confs, rows)
            np.minimum(best, drep.min(axis=1), out=best)
            self.stats["bounds_s"] += _time.perf_counter() - t0
        surv_c, surv_b = np.nonzero(lb - err <= best[:, None] + err)
        order = np.argsort(lb[surv_c, surv_b], kind="stable")
        surv_c, surv_b = surv_c[order], surv_b[order]
        return surv_c, surv_b, lb[surv_c, surv_b]

    def min_distances(self, confs: np.ndarray) -> np.ndarray:
        """Per-configuration min distance from any posed robot vertex to the
        obstacle surface, minus :meth:`err_bound` (a sound lower bound),
        float64 [b].

        A pair is dropped only while ``LB - err > best + err``; the true LB
        is >= LB - err, the true answer <= best + err, and best only
        decreases, so no dropped pair can hold the minimum.

        Under a profiler the call is the span ``rc.clearance``, holding
        ``.upload``, ``.bounds`` (the region of ``stats["bounds_s"]``; its
        ``.reps``, the representatives' launches and fetch), one ``.exact``
        a wave (the region of ``stats["exact_s"]``), ``.fetch`` under
        ``.reps`` and each ``.exact``, and ``.scatter``
        (`profiling.timers.span`)."""
        with span("rc.clearance"):
            confs = np.asarray(confs, dtype=np.float32).reshape(-1, 6)
            b = len(confs)
            if b == 0:
                return np.zeros(0, dtype=np.float64)
            self.stats["calls"] += 1
            self.stats["configs"] += b
            err = self.err_bound(confs)
            best = np.full(b, np.inf, dtype=np.float64)
            with span("rc.clearance.upload"):
                dev_confs = torch.as_tensor(confs).to(self.device)
                rows = pose_rows(dev_confs)
            if self.num_blocks == 1:
                self._run_pairs(rows, np.arange(b), np.zeros(b, np.int64), best, err)
                return best - err

            # Phase 2: surviving pairs in ascending-LB waves.
            surv_c, surv_b, slb = self._survivors(dev_confs, rows, best, err)
            wave = max(2048, 4 * b)
            while len(surv_c):
                self._run_pairs(rows, surv_c[:wave], surv_b[:wave], best, err)
                surv_c, surv_b, slb = surv_c[wave:], surv_b[wave:], slb[wave:]
                if len(surv_c):
                    keep = slb - err <= best[surv_c] + err
                    surv_c, surv_b, slb = surv_c[keep], surv_b[keep], slb[keep]
            return best - err


def clearance_queries(obstacle: Mesh, n: int = 256, seed: int = 5) -> np.ndarray:
    """The headline bench's clearance queries (`bench.py:186-190`): random
    rotations, translations within 0.6x the obstacle's extent of its center."""
    rng = np.random.default_rng(seed)
    confs = rng.uniform(-np.pi, np.pi, (n, 6)).astype(np.float32)
    center = 0.5 * (obstacle.aabb[:3] + obstacle.aabb[3:])
    ext = obstacle.aabb[3:] - obstacle.aabb[:3]
    confs[:, 0:3] = center + rng.uniform(-0.6, 0.6, (n, 3)) * ext
    return confs


def native_min_distances(robot_verts: np.ndarray, obstacle: Mesh,
                         confs: np.ndarray) -> np.ndarray:
    """float64 truth for ``min_distances``: the native BVH's min distance over
    each configuration's posed vertices (R from the float32 rotation, posed
    in float64). Needs the native library (``runtime.native``)."""
    from ..runtime import native

    R = rotation_matrices(torch.from_numpy(confs)).double().numpy()
    v = np.asarray(robot_verts, np.float64)
    return np.array([native.point_mesh_dist(obstacle.vertices, obstacle.triangles,
                                            v @ R[i].T + confs[i, 0:3].astype(np.float64)).min()
                     for i in range(len(confs))])
