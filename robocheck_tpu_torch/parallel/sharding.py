"""Batch sharding of the collision check over the ranks of a process group
(PyTorch port of `robocheck_tpu.parallel.sharding`).

The JAX package shards along the one "batch" axis of a device mesh inside
one program. Here each rank is a process (`runtime.distributed`): every
rank holds the mesh pair's tables, checks its contiguous shard of the rows
with the fused kernel (`kernels.megakernel`), and the verdicts are
all-gathered in row order; global counts are all-reduced. A world of 1
needs no process group and runs no collective.

Collectives go through ``ProcessMesh.all_gather`` / ``all_reduce_sum``.
Under "gloo" their payloads (a byte per row, a float per pair, three counts)
travel as CPU tensors, since gloo gathers only CPU tensors; that is also
the backend for several ranks on one card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..core.types import Mesh, validate_confs
from ..kernels.megakernel import OUT_COLS, MegaKernelChecker, stats_columns, valid_coplanar
from ..runtime.device import resolve as resolve_device


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """The torch form of a one-axis device mesh: the process group (None
    for a world of 1), this rank, the world size, this rank's device and the
    group's backend (None without a group)."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str | None

    def shard(self, n: int) -> tuple[int, int]:
        """This rank's rows [lo, hi) of ``n`` rows, ``n`` a multiple of the
        world size (equal contiguous shards, in rank order)."""
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (the same shape on each) concatenated along
        dim 0 in rank order, on ``t``'s device."""
        if self.size == 1:
            return t
        payload = (t.cpu() if self.backend == "gloo" else t).contiguous()
        parts = [torch.empty_like(payload) for _ in range(self.size)]
        dist.all_gather(parts, payload, group=self.group)
        return torch.cat(parts).to(t.device)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``t``, on ``t``'s device."""
        if self.size == 1:
            return t
        payload = (t.cpu() if self.backend == "gloo" else t).clone()
        dist.all_reduce(payload, group=self.group)
        return payload.to(t.device)


def make_mesh(num_devices: int | None = None, device: torch.device | str = "cuda",
              backend: str | None = None) -> ProcessMesh:
    """The mesh over the initialised process group (every rank), or a world
    of 1 where no group is initialised or ``num_devices`` is 1.
    ``num_devices`` other than 1 must equal the group's size. ``backend``,
    where given, must be the group's. On "cuda" each rank takes card
    rank % device count and makes it its current device (raises without a
    card)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if backend is not None:
            raise ValueError(f"backend {backend!r} asked for, but no process group is "
                             "initialised")
        return ProcessMesh(None, 0, 1, _rank_device(dev, 0), None)
    if num_devices == 1:
        return ProcessMesh(None, 0, 1, _rank_device(dev, dist.get_rank()), None)
    size, rank = dist.get_world_size(), dist.get_rank()
    group_backend = str(dist.get_backend())
    if num_devices is not None and num_devices != size:
        raise ValueError(f"a mesh of {num_devices} ranks asked for in a group of {size}")
    if backend is not None and backend != group_backend:
        raise ValueError(f"backend {backend!r} asked for, but the group runs "
                         f"{group_backend!r}")
    dev = _rank_device(dev, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # "cuda" without an index means this rank's card
    return ProcessMesh(dist.group.WORLD, rank, size, dev, group_backend)


def _rank_device(dev: torch.device, rank: int) -> torch.device:
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


class ShardedChecker:
    """Batch-parallel collision checking over the ranks of ``mesh`` (default
    ``make_mesh(device=device)``), with the single checker's verdicts: every
    rank checks its contiguous shard of the rows with `MegaKernelChecker`,
    padded with far-away rows (x = 1e9, which end at the kernel's broad
    phase) so that the shards are equal.

    ``check_block`` runs the stats path (the counter kernel) and all-reduces
    [valid, colliding, coplanar] counts; ``check_valid`` /
    ``check_packed`` / ``check_valid_resolved`` the packed kernel;
    ``check_valid_distributed`` lets each rank pass only its own rows."""

    # Configurations per kernel launch on each rank in ``check_valid``.
    STREAM_CHUNK_PER_DEVICE = 16384

    def __init__(self, robot: Mesh, obstacle: Mesh, mesh: ProcessMesh | None = None,
                 morton: bool = True, device: torch.device | str = "cuda"):
        if mesh is None:
            mesh = make_mesh(device=device)
        elif torch.device(device).type != mesh.device.type:
            raise ValueError(f"device {device!r} asked for on a mesh of {mesh.device}")
        self.mesh = mesh
        self.robot = robot
        self.obstacle = obstacle
        self._checker = MegaKernelChecker(robot, obstacle, mesh.device, morton)
        self.device = mesh.device
        self.tables = self._checker.tables

    def _padded(self, confs: np.ndarray) -> np.ndarray:
        pad = (-confs.shape[0]) % self.mesh.size
        if not pad:
            return confs
        tail = np.zeros((pad, 6), dtype=np.float32)
        tail[:, 0] = 1.0e9  # far away: ends at the kernel's broad phase
        return np.concatenate([confs, tail])

    def check_block(self, confs) -> tuple[torch.Tensor, torch.Tensor]:
        """[B,6] configurations (numpy or a tensor), B a multiple of the
        world size -> ([B, OUT_COLS] int32 counter rows, [3] int64 totals
        [valid, colliding, coplanar] over all ranks), both on the host."""
        confs = torch.as_tensor(confs, dtype=torch.float32)
        if confs.shape[0] % self.mesh.size:
            raise ValueError(f"check_block takes a multiple of {self.mesh.size} rows, "
                             f"got {confs.shape[0]}")
        if confs.shape[0] == 0:  # the same on every rank: nothing to exchange
            return torch.zeros((0, OUT_COLS), dtype=torch.int32), torch.zeros(3, dtype=torch.int64)
        lo, hi = self.mesh.shard(confs.shape[0])
        out = self._checker.check_block(confs[lo:hi].to(self.device)).cpu()
        local = torch.stack([out[:, 0].sum(), (1 - out[:, 0]).sum(),
                             out[:, 1].sum()]).to(torch.int64)
        return self.mesh.all_gather(out), self.mesh.all_reduce_sum(local)

    def broad_block(self, confs) -> np.ndarray:
        """[B,6] -> [B] bool mesh-box overlap (the kernel's stage 1 bit for
        bit), on every rank for the whole batch: it is tiny next to the
        narrow phase."""
        return self._checker.broad_block(confs).cpu().numpy()

    def check(self, confs: np.ndarray, two_phase: bool = True):
        """[N,6] -> (valid, coplanar, num_pairs, broad) numpy arrays,
        `MegaKernelChecker.check`'s (`megakernel.stats_columns`), with the
        counter rows from ``check_block`` on every rank's shard."""
        def rows(c):
            return self.check_block(self._padded(c))[0][: c.shape[0]].numpy()

        return stats_columns(confs, two_phase, self.broad_block, rows)

    def _on_shards(self, check, confs: np.ndarray, chunk: int | None) -> np.ndarray:
        """[N,6] -> [N] bytes: ``check`` (a `MegaKernelChecker` method, a
        byte a row) on this rank's shard of the rows, in chunks of ``chunk //
        world size`` rows (default STREAM_CHUNK_PER_DEVICE); one all-gather
        returns the bytes in row order."""
        confs = validate_confs(confs)
        n = confs.shape[0]
        if n == 0:  # the same on every rank: nothing to exchange
            return np.zeros((0,), dtype=np.uint8)
        per_rank = max(1, (chunk or self.STREAM_CHUNK_PER_DEVICE * self.mesh.size)
                       // self.mesh.size)
        padded = self._padded(confs)
        lo, hi = self.mesh.shard(padded.shape[0])
        local = check(padded[lo:hi], chunk=per_rank).view(np.uint8)
        return self.mesh.all_gather(torch.from_numpy(local)).numpy()[:n]

    def check_packed(self, confs: np.ndarray, chunk: int | None = None) -> np.ndarray:
        """[N,6] -> [N] uint8 verdict bytes (bit 0 valid, bit 1 coplanar,
        bit 2 uncertain), the single checker's: bit 0 on every row, the whole
        byte on valid rows. (On a colliding row the CUDA kernel's bits 1-2
        depend on the pairs it reached before its any-hit exit, an order its
        warps settle at run time, so two calls of one checker may differ
        there too.) Non-finite rows get the byte 0 (from K1)."""
        return self._on_shards(self._checker.check_packed, confs, chunk)

    def check_valid(self, confs: np.ndarray, chunk: int | None = None):
        """[N,6] -> (valid[N], coplanar[N]) numpy bools: bits 0 and 1 of
        ``check_packed``."""
        return valid_coplanar(self.check_packed(confs, chunk=chunk))

    def check_valid_resolved(self, confs: np.ndarray, chunk: int | None = None) -> np.ndarray:
        """``check_packed`` + the float64 re-check of valid rows flagged
        coplanar (bit 1) or uncertain (bit 2), each rank its own shard's on
        its device. Returns valid[N] bool."""
        return self._on_shards(self._checker.check_valid_resolved, confs, chunk).view(bool)

    def check_valid_distributed(self, local_confs: np.ndarray, global_n: int):
        """Multi-host throughput path: each rank passes only its own rows of
        a global batch of ``global_n`` rows, the slice
        `runtime.distributed.shard_bounds(global_n)` gives it, and gets the
        (valid, coplanar) verdicts of exactly those rows. No rank holds the
        global batch, and no collective is needed: the verdicts are per
        row."""
        from ..runtime.distributed import shard_bounds

        local_confs = validate_confs(local_confs)
        lo, hi = shard_bounds(global_n, self.mesh.rank, self.mesh.size)
        if local_confs.shape[0] != hi - lo:
            raise ValueError(f"rank {self.mesh.rank} owns rows [{lo}, {hi}) of {global_n}, "
                             f"got {local_confs.shape[0]} rows")
        return valid_coplanar(self._checker.check_packed(local_confs))
