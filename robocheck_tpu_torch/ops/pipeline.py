"""The dense reference pipeline (PyTorch port of `robocheck_tpu.ops.pipeline`).

Reference counterpart: `broad-phase-fused.cu:365-521` ``broadPhaseFused_sep``,
the reference's ``check()``: transform + AABB + broad phase, then the narrow
phase. Here every stage is torch ops, with no kernel of its own (the JAX
package's is XLA, with no ``pallas_call``):

  stage 1: configurations [B,6] -> posed vertices [B,V,3] -> robot box [B,6]
      -> mesh-level broad mask;
  stage 2: per-triangle boxes of the posed robot [C,Tr,6] against the
      obstacle's precomputed boxes [To,6] -> pair mask [C,Tr,To], for a chunk
      of ``narrow_chunk`` of the block's broad-phase hits (a configuration
      whose robot box misses the obstacle's has an empty pair mask: its
      triangle boxes lie inside its robot box, the obstacle's inside the
      obstacle's box);
  stage 3: compaction: ``torch.nonzero`` of the chunk's whole mask gives its
      surviving (configuration, robot triangle, obstacle triangle) triples;
  stage 4: the Moller interval test (`ops.narrow.pair_intersects`) on the
      triples, in pieces of at most ``narrow_chunk * max_pairs`` pairs, and an
      any-hit / any-coplanar reduce per configuration by ``index_add_`` over
      the configuration index (no per-configuration loop: on the card each
      ``nonzero`` is a sync).

The JAX package compacts into a fixed buffer of ``max_pairs`` per
configuration and flags an ``overflow`` where more pairs survive; here the
compaction has the exact size, so no verdict can overflow and ``overflow``
is all False (``max_pairs`` only bounds the memory of a piece).

Coplanar pairs are flagged in the fast path; `CollisionWorld.check`
re-verdicts flagged configurations with the float64 oracle. Its verdicts
follow the reference's +-TOL band, like the JAX package's `CollisionWorld`
(not the fused kernel's bit-2 path, which sends rounding-decided rows to the
oracle too).

Verdict polarity throughout: ``valid == True`` means collision-free
(`Utils_rai.h:60`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core import constants
from ..core.types import Mesh, validate_confs
from ..runtime.device import resolve as resolve_device
from . import aabb as aabb_ops
from . import narrow as narrow_ops
from . import transform as transform_ops


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Runtime knobs (the reference's compile-time #defines, promoted to a
    config object)."""

    # Bounds the pairs of one piece of the narrow phase: narrow_chunk x
    # max_pairs (the JAX package's per-configuration pair buffer).
    max_pairs: int = 16384
    # Configurations whose [C, Tr, To] pair mask is built and compacted at once.
    narrow_chunk: int = 8
    # Configurations per block of ``check``.
    batch_block: int = 2048
    # Resolve coplanar-flagged configurations with the float64 oracle.
    resolve_coplanar: bool = True
    # Lane padding multiple for triangle arrays.
    lane: int = constants.LANE


class CheckResult(NamedTuple):
    valid: torch.Tensor  # [B] bool: True = collision-free
    broad_valid: torch.Tensor  # [B] bool: True = culled by the mesh-level box
    coplanar: torch.Tensor  # [B] bool: needs coplanar resolution
    overflow: torch.Tensor  # [B] bool: all False (exact-size compaction)
    num_pairs: torch.Tensor  # [B] int32: surviving pair count (stats)


def broad_phase(confs: torch.Tensor, robot_vertices: torch.Tensor,
                obstacle_aabb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Transform + AABB + mesh-level broad phase. Returns (valid [B] bool,
    posed vertices [B,V,3])."""
    verts = transform_ops.transform_vertices(confs, robot_vertices)
    overlap = aabb_ops.aabb_overlap(aabb_ops.vertices_aabb(verts), obstacle_aabb)
    return ~overlap, verts


def _narrow_one_chunk(verts, rob_tris, rob_tri_mask, obs_tri_verts, obs_tri_aabbs,
                      obs_planes, max_pairs):
    """Narrow phase of a chunk of C configurations: (hit [C], coplanar [C],
    num_pairs [C] int32)."""
    c = verts.shape[0]
    rob_tri_verts = verts[:, rob_tris]  # [C, Tr, 3, 3]
    rob_tri_aabbs = aabb_ops.triangle_aabbs(rob_tri_verts)  # [C, Tr, 6]
    # Robot padding rows (degenerate point boxes) are masked off.
    pair_mask = aabb_ops.aabb_overlap(rob_tri_aabbs[:, :, None, :],
                                      obs_tri_aabbs[None, None, :, :])
    pair_mask &= rob_tri_mask[None, :, None]
    num_pairs = pair_mask.sum(dim=(1, 2), dtype=torch.int32)
    ci, ri, oi = pair_mask.nonzero(as_tuple=True)
    hits = torch.zeros((c,), dtype=torch.int32, device=verts.device)
    cops = torch.zeros_like(hits)
    piece = c * max_pairs
    for lo in range(0, ci.shape[0], piece):
        cp, rp, op = ci[lo : lo + piece], ri[lo : lo + piece], oi[lo : lo + piece]
        res = narrow_ops.pair_intersects(rob_tri_verts[cp, rp], obs_tri_verts[op],
                                         plane_o=(obs_planes[0][op], obs_planes[1][op]))
        hits.index_add_(0, cp, res.collides.to(torch.int32))
        cops.index_add_(0, cp, res.coplanar.to(torch.int32))
    return hits > 0, cops > 0, num_pairs


def check_block(confs: torch.Tensor, robot_vertices: torch.Tensor, rob_tris: torch.Tensor,
                rob_tri_mask: torch.Tensor, obs_tri_verts: torch.Tensor,
                obs_tri_aabbs: torch.Tensor, obs_planes_n: torch.Tensor,
                obs_planes_d: torch.Tensor, obstacle_aabb: torch.Tensor, *,
                max_pairs: int, narrow_chunk: int) -> CheckResult:
    """The pipeline over one block of configurations [B,6], any B: the
    narrow phase runs on the broad-phase hits only, in chunks of
    ``narrow_chunk`` (the last may be short)."""
    broad_valid, verts = broad_phase(confs, robot_vertices, obstacle_aabb)
    b = confs.shape[0]
    hits = torch.zeros((b,), dtype=torch.bool, device=confs.device)
    cops = torch.zeros_like(hits)
    num_pairs = torch.zeros((b,), dtype=torch.int32, device=confs.device)
    idx = (~broad_valid).nonzero()[:, 0]
    for lo in range(0, idx.shape[0], narrow_chunk):
        rows = idx[lo : lo + narrow_chunk]
        hits[rows], cops[rows], num_pairs[rows] = _narrow_one_chunk(
            verts[rows], rob_tris, rob_tri_mask, obs_tri_verts, obs_tri_aabbs,
            (obs_planes_n, obs_planes_d), max_pairs)
    return CheckResult(~hits, broad_valid, cops, torch.zeros_like(hits), num_pairs)


class CollisionWorld:
    """Checker for one robot/obstacle mesh pair through the dense reference
    pipeline, on ``device`` ("cuda" by default, or "cpu"). The meshes are
    prepared and placed once at construction; ``check`` streams
    configuration batches."""

    def __init__(self, robot: Mesh, obstacle: Mesh, config: PipelineConfig | None = None,
                 device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        self.robot = robot
        self.obstacle = obstacle
        self.config = cfg = config or PipelineConfig()

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        rob_p = robot.padded(cfg.lane)
        obs_p = obstacle.padded(cfg.lane)
        self._rob_tris = put(rob_p.triangles.astype(np.int64))
        self._rob_tri_mask = put(rob_p.tri_mask)
        self._rob_verts = put(robot.vertices)
        obs_tri_verts = obs_p.triangle_vertices.astype(np.float32)
        self._obs_tri_verts = put(obs_tri_verts)
        # Obstacle triangle boxes, once; padding triangles get an empty box
        # (+inf lo, -inf hi) so they never survive the pair cull.
        aabbs = np.concatenate([obs_tri_verts.min(axis=1), obs_tri_verts.max(axis=1)], axis=-1)
        aabbs[~obs_p.tri_mask, :3] = np.inf
        aabbs[~obs_p.tri_mask, 3:] = -np.inf
        self._obs_tri_aabbs = put(aabbs)
        self._obs_plane_n, self._obs_plane_d = narrow_ops.compute_plane(self._obs_tri_verts)
        self._obs_aabb = put(obstacle.aabb)

    def _run_block(self, confs: torch.Tensor) -> CheckResult:
        return check_block(confs, self._rob_verts, self._rob_tris, self._rob_tri_mask,
                           self._obs_tri_verts, self._obs_tri_aabbs, self._obs_plane_n,
                           self._obs_plane_d, self._obs_aabb,
                           max_pairs=self.config.max_pairs,
                           narrow_chunk=self.config.narrow_chunk)

    def check(self, confs: np.ndarray, return_result: bool = False):
        """Check a host batch; returns ``valid[N]`` numpy bool (True =
        collision-free), and with ``return_result`` also a `CheckResult` of
        numpy arrays.

        Streams blocks of ``batch_block`` rows through the pipeline.
        Configurations flagged coplanar are re-verdicted by the float64
        oracle (``config.resolve_coplanar=False`` keeps the raw flags)."""
        confs = validate_confs(confs)
        block = self.config.batch_block
        parts = [self._run_block(torch.from_numpy(confs[s : s + block]).to(self.device))
                 for s in range(0, confs.shape[0], block)]
        if parts:
            res = CheckResult(*(torch.cat(f).cpu().numpy() for f in zip(*parts)))
        else:
            res = CheckResult(*(np.zeros((0,), dt) for dt in (bool, bool, bool, bool, np.int32)))
        valid = res.valid.copy()
        fixup = np.flatnonzero(res.coplanar | res.overflow)
        if fixup.size and self.config.resolve_coplanar:
            from ..oracle import check_configs

            valid[fixup] = check_configs(self.robot, self.obstacle, confs[fixup])
        if return_result:
            return valid, res._replace(valid=valid)
        return valid
