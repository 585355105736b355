"""Oversized meshes: the fused check over Morton-ordered mesh chunks, and the
dispatch between it and the plain checker.

PyTorch port of `robocheck_tpu.kernels.chunked`. The kernel keeps the
configuration-invariant tables in shared memory, once per block, so a mesh
pair whose tables pass the block's budget (`megakernel.smem_bytes`) or the
kernel's row limit cannot run as one launch. Here either mesh is cut into
Morton-ordered triangle chunks, each (robot chunk x obstacle chunk) pair runs
the ordinary kernel, and the verdicts combine exactly:

    collision(robot, obstacle) == any over chunk pairs of collision(rc, oc)

because the chunks partition the triangles and the triangle test is per
pair. So the packed byte's bit 0 (valid) ANDs, bits 1 (coplanar) and 2
(uncertain) OR (kept on valid rows), and so do the stats path's columns
(``num_pairs`` sums).

``make_checker`` is the entry point: a plain `MegaKernelChecker` where the
pair fits, a `ChunkedMegaKernelChecker` otherwise; with ``mesh=`` (a
`parallel.sharding.ProcessMesh`) every check is sharded over its ranks
(`ShardedChecker`), so oversized meshes and several ranks compose.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.types import Mesh, validate_confs
from ..profiling.timers import span
from ..utils.morton import morton_argsort
from .megakernel import (MegaKernelChecker, SharedMemoryBudgetError, _nonfinite_rows,
                         boxes_overlap, poses_from_confs, robot_bounds, valid_coplanar)
from .resolve import ResolveTables, resolve_rows

# Chunk caps: any (robot chunk, obstacle chunk) pair fits one block of the
# kernel. 1,024 robot rows (the alpha-1.0 robot's own table) and 6,144
# obstacle rows (48 groups) take smem_bytes(1024, 48) = 227,120 bytes, under
# the H100's 232,448 per block (49 groups: 230,728, 50: 234,336). The robot
# chunk is posed once per row per obstacle chunk, so a small robot cap and a
# large obstacle cap keep the pose passes few: an 81,920-triangle obstacle
# takes 14 chunks against any robot of up to 1,024 triangles.
MAX_ROB_TRIS = 1024
MAX_OBS_TRIS = 6144


def split_mesh(mesh: Mesh, max_tris: int) -> list[Mesh]:
    """Split into Morton-ordered contiguous triangle chunks of at most
    ``max_tris`` (spatially tight, which keeps each chunk's box, and so the
    broad phase, effective); the JAX package's `split_mesh`."""
    t = mesh.num_triangles
    if t <= max_tris:
        return [mesh]
    order = morton_argsort(mesh.triangle_vertices.mean(axis=1))
    n_chunks = -(-t // max_tris)
    per = -(-t // n_chunks)
    return [Mesh(mesh.vertices, mesh.triangles[order[k * per : (k + 1) * per]],
                 name=f"{mesh.name}[{k}]") for k in range(n_chunks)]


class ChunkedMegaKernelChecker:
    """The fused check for mesh pairs past one kernel block's budget, with
    `MegaKernelChecker`'s interface (``check_packed``, ``check_valid``,
    ``check_valid_resolved``, ``check``), on the card by default.

    Every chunk pair's launch runs its own broad phase, so rows that miss a
    chunk's box end there. ``compact=True`` instead finds each chunk pair's
    broad-phase hits first, from one robot box per row and robot chunk
    (`megakernel.robot_bounds`, the kernel's stage 1 bit for bit) against
    every obstacle chunk's box, and launches each chunk pair on its hits
    only. Verdicts are identical either way: a row it skips is one that
    chunk pair's kernel would have ended at its broad phase.

    By default (``compact`` off, no ``mesh``) a call stays on the device
    until its one fetch: one upload of the batch, one K2 for the pose rows
    every chunk pair shares, each chunk pair's K1 launch on them back to
    back, and the bytes combined by a few device ops. With ``compact`` or
    ``mesh`` (each chunk pair then a `ShardedChecker` over its ranks) each
    chunk pair runs its own checker's ``check_packed`` on its rows, and the
    bytes combine on the host.

    Under a profiler ``check_valid_resolved`` is the span ``rc.chunked``,
    holding ``rc.chunked.broad`` (``_broad_multi``, with ``compact`` only),
    ``rc.chunked.pairs`` (by default the upload, K2, the chunk pairs' K1
    issue and the device combine; per chunk pair, each pair's
    ``rc.check.*`` steps and the host combine), ``rc.chunked.resolve`` (the
    resolution's issue, after the upload of the bytes and the batch per
    chunk pair) and ``rc.chunked.fetch``; ``check_packed`` alone emits its
    steps without the root."""

    def __init__(self, robot: Mesh, obstacle: Mesh, device: torch.device | str = "cuda",
                 morton: bool = True, max_rob_tris: int = MAX_ROB_TRIS,
                 max_obs_tris: int = MAX_OBS_TRIS, mesh=None):
        self.robot = robot
        self.obstacle = obstacle
        self._sharded = mesh is not None
        if mesh is not None:
            from ..parallel.sharding import ShardedChecker

            def build(r, o):
                return ShardedChecker(r, o, mesh, morton, device)
        else:
            def build(r, o):
                return MegaKernelChecker(r, o, device, morton)
        rob_chunks = split_mesh(robot, max_rob_tris)
        obs_chunks = split_mesh(obstacle, max_obs_tris)
        self._n_obs_chunks = len(obs_chunks)
        # Robot-major: checker i holds robot chunk i // n_obs_chunks.
        self.checkers = [build(r, o) for r in rob_chunks for o in obs_chunks]
        self.device = self.checkers[0].device
        self.resolve_tables = ResolveTables.build(robot, obstacle, self.device)
        # Chunk pairs run, the rows handed to them and the batch's copies to
        # the device, on the host; rows the resolution re-checked in float64
        # and those it found colliding, counted on the device. Read only by
        # ``counters``.
        self._pair_launches = 0
        self._pair_rows = 0
        self._uploads = 0
        self._resolved = torch.zeros((2,), dtype=torch.int64, device=self.device)

    @property
    def num_chunk_pairs(self) -> int:
        return len(self.checkers)

    def counters(self) -> dict:
        """Counts since the checker was made: {"pair_launches": chunk pairs
        run (a K1 launch on the shared pose rows, or one call of a chunk
        pair's checker, each), "pair_rows": the rows handed to them, summed
        over the chunk pairs, "batch_uploads": copies of a batch from the
        host to the device (one a call by default; per chunk pair, one a
        pair run, plus ``_broad_multi``'s and the resolution's),
        "nonfinite_rows": the chunk pairs' K1 counts of non-finite rows,
        summed, "resolved_rows" / "resolved_colliding": valid rows flagged
        coplanar or uncertain that ``check_valid_resolved`` re-checked in
        float64, and those of them found colliding}. One device read; no
        check call makes it."""
        nonfinite = [getattr(ck, "_checker", ck)._nonfinite.view(1) for ck in self.checkers]
        *each, rows, colliding = torch.cat(nonfinite + [self._resolved]).tolist()
        return {"pair_launches": self._pair_launches, "pair_rows": self._pair_rows,
                "batch_uploads": self._uploads, "nonfinite_rows": sum(each),
                "resolved_rows": rows, "resolved_colliding": colliding}

    def check_packed(self, confs: np.ndarray, chunk: int | None = None,
                     compact: bool = False) -> np.ndarray:
        """[N,6] configurations -> [N] uint8 verdict bytes of the whole mesh
        pair: bit 0 (valid) ANDed over the chunk pairs, bits 1 (coplanar)
        and 2 (uncertain) ORed and kept on valid rows only. (On a colliding
        row they depend on which pairs each launch reached before its
        any-hit exit, whose order the kernel's warps settle at run time;
        nothing reads them there.) Non-finite rows get the byte 0. Each
        chunk pair's K1 runs in one launch, or in launches of ``chunk``
        rows when given."""
        if compact or self._sharded:
            return self._check_pairs(validate_confs(confs), chunk, compact)
        with span("rc.chunked.pairs"):
            checked = self._check_on_device(confs, chunk)
        if checked is None:
            return np.zeros((0,), dtype=np.uint8)
        with span("rc.chunked.fetch"):
            return checked[1].cpu().numpy()

    def _check_on_device(self, confs: np.ndarray, chunk: int | None):
        """The default route up to its fetch: (the batch [N,6] and the
        combined verdict bytes [N], both on the device), or None for an
        empty batch. One upload and one K2; every chunk pair's K1 is issued
        on the shared pose rows with its own tables and non-finite counter,
        with no sync between launches; the bytes combine as
        ``_check_pairs``'s do, on the device."""
        confs = validate_confs(confs)
        n = confs.shape[0]
        if n == 0:
            return None
        dev_confs = torch.from_numpy(confs).to(self.device)
        self._uploads += 1
        poses = poses_from_confs(dev_confs)
        parts = torch.stack([ck._launches(poses, chunk) for ck in self.checkers])
        self._pair_launches += self.num_chunk_pairs
        self._pair_rows += self.num_chunk_pairs * n
        valid = (parts & 1).amin(0)
        flags = (parts & 2).amax(0) | (parts & 4).amax(0)
        return dev_confs, valid | flags * valid

    def _check_pairs(self, confs: np.ndarray, chunk: int | None, compact: bool) -> np.ndarray:
        """``check_packed`` per chunk pair on validated ``confs``: each chunk
        pair's checker on every row, or with ``compact`` on its broad-phase
        hits alone, the bytes combined on the host."""
        n = confs.shape[0]
        valid = np.ones((n,), dtype=np.uint8)
        flags = np.zeros_like(valid)
        hits = None
        if compact:
            with span("rc.chunked.broad"):
                hits = self._broad_multi(confs)
        with span("rc.chunked.pairs"):
            for k, ck in enumerate(self.checkers):
                idx = np.flatnonzero(hits[k]) if compact else slice(None)
                rows = idx.size if compact else n
                if not rows:
                    continue
                packed = ck.check_packed(confs[idx], chunk=chunk)
                self._pair_launches += 1
                self._pair_rows += rows
                self._uploads += 1
                valid[idx] &= packed & 1
                flags[idx] |= packed & 6
            return valid | flags * valid

    def check_valid(self, confs: np.ndarray, chunk: int | None = None,
                    compact: bool = False):
        """[N,6] configurations -> (valid[N], coplanar[N]) numpy bools: bits 0
        and 1 of ``check_packed``."""
        return valid_coplanar(self.check_packed(confs, chunk=chunk, compact=compact))

    def check_valid_resolved(self, confs: np.ndarray, chunk: int | None = None,
                             compact: bool = False) -> np.ndarray:
        """``check_packed`` + the float64 re-check on the device, against the
        whole (unchunked) mesh pair, of the valid rows that some chunk pair
        flagged coplanar (bit 1) or uncertain (bit 2), counted in
        ``counters``; by default on the bytes and the batch the chunk pairs
        left on the device, with one fetch of the verdicts. Returns valid[N]
        bool."""
        with span("rc.chunked"):
            if compact or self._sharded:
                confs = validate_confs(confs)
                packed = self._check_pairs(confs, chunk, compact)
                with span("rc.chunked.resolve"):
                    self._uploads += 1
                    verdicts = resolve_rows(torch.from_numpy(packed).to(self.device),
                                            torch.from_numpy(confs).to(self.device),
                                            self.resolve_tables, self._resolved)
            else:
                with span("rc.chunked.pairs"):
                    checked = self._check_on_device(confs, chunk)
                if checked is None:
                    return np.zeros((0,), dtype=bool)
                with span("rc.chunked.resolve"):
                    verdicts = resolve_rows(checked[1], checked[0], self.resolve_tables,
                                            self._resolved)
            with span("rc.chunked.fetch"):
                return verdicts.cpu().numpy().view(bool)

    def _broad_multi(self, confs: np.ndarray) -> np.ndarray:
        """[num_chunk_pairs, N] bool: each chunk pair's broad phase, bit for
        bit its kernel's stage 1. The robot box of every row is computed on
        the device once per robot chunk and tested there against each of
        its obstacle chunks' boxes (on the card by K5 over the robot chunk's
        vertex table, built with its tables); one fetch per robot chunk.
        Non-finite rows are hits, so that K1 answers them with the byte 0."""
        out = np.empty((self.num_chunk_pairs, confs.shape[0]), dtype=bool)
        if not confs.shape[0]:
            return out
        poses = poses_from_confs(torch.from_numpy(confs).to(self.device))
        self._uploads += 1
        bad = _nonfinite_rows(poses, None)
        for lo in range(0, self.num_chunk_pairs, self._n_obs_chunks):
            group = self.checkers[lo : lo + self._n_obs_chunks]
            bounds = robot_bounds(poses, group[0].tables)
            boxes = torch.stack([ck.tables.obs_mesh for ck in group])
            out[lo : lo + len(group)] = (boxes_overlap(bounds, boxes) | bad).cpu().numpy()
        return out

    def check(self, confs: np.ndarray, two_phase: bool = True):
        """[N,6] configurations -> (valid, coplanar, num_pairs, broad), each
        combined over the chunk pairs: valid ANDs, coplanar and broad OR,
        num_pairs sums (`MegaKernelChecker.check`'s columns)."""
        valid, coplanar, num_pairs, broad = self.checkers[0].check(confs, two_phase)
        for ck in self.checkers[1:]:
            v, c, p, b = ck.check(confs, two_phase)
            valid &= v
            coplanar |= c
            num_pairs += p
            broad |= b
        return valid, coplanar, num_pairs, broad


def make_checker(robot: Mesh, obstacle: Mesh, device: torch.device | str = "cuda",
                 morton: bool = True, mesh=None):
    """One checker for any mesh sizes, on the card by default: the fused
    `MegaKernelChecker` where the pair fits one kernel block, the
    Morton-chunked one otherwise; sharded over the ranks of ``mesh`` (a
    `parallel.sharding.ProcessMesh`) when one is given."""
    try:
        if mesh is not None:
            from ..parallel.sharding import ShardedChecker

            return ShardedChecker(robot, obstacle, mesh, morton, device)
        return MegaKernelChecker(robot, obstacle, device, morton)
    except SharedMemoryBudgetError:
        return ChunkedMegaKernelChecker(robot, obstacle, device, morton, mesh=mesh)
