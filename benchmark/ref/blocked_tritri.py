"""Plain collision verdicts that scale with the obstacle: `ref/tritri.py`'s
verdicts and columns for obstacles of tens of thousands of triangles.

The same quantity as `tritri.MeshPair`, whose (row, robot triangle, group)
box test over every obstacle group is 64 times the work at 64,512
triangles. Here the obstacle's triangles, in Morton order of their
centroids, are cut into blocks of BLOCK triangles as into groups of
`tritri.GROUP`, and pairs are culled by boxes only, each step sound in exact
arithmetic (a box holds the boxes of all it covers, and min / max round
nothing):

  1. each row's posed robot box against every block's box;
  2. each robot triangle's box against the blocks that survive for its row;
  3. against the GROUP-triangle groups of the blocks it meets;
  4. against each member's box: the box-overlapping pairs, each decided by
     `tritri.pairs_intersect` (Moller with exact predicates and the 2-D
     coplanar path).

Rows whose robot box misses the obstacle's are never culled further, as in
`MeshPair`, so the three columns (valid, box-overlapping pairs, robot box
meets obstacle box) are `MeshPair.check`'s for any obstacle. Torch
operations only, in the dtype given (float64 for the reference, float32 for
its control), on any device, in pieces that fit the card; nothing of the
program is imported.
"""
from __future__ import annotations

import numpy as np
import torch

from .mesh import morton_order, posed
from .tritri import GROUP, _boxes, _meets, pairs_intersect

# Obstacle triangles a block: a whole number of groups.
BLOCK = 512
# Candidates a step holds in steps 3 and 4: (row, robot triangle, obstacle
# group) triples, and box-overlapping pairs.
STEP_PAIRS = 1 << 23


def _pooled(lo, hi, size):
    """Boxes of consecutive runs of ``size`` of the boxes [n, 3] (n a
    multiple of ``size``)."""
    return lo.reshape(-1, size, 3).amin(dim=1), hi.reshape(-1, size, 3).amax(dim=1)


class BlockedMeshPair:
    """The robot's triangles (rest frame) and the obstacle's, with the
    obstacle's block and group boxes, as tensors of ``dtype`` on ``device``.
    A short last block takes copies of the first triangle's box, which are
    never members."""

    def __init__(self, robot: tuple, obstacle: tuple, device, dtype=torch.float64):
        rv, rt = robot
        ov, ot = obstacle
        self.dtype, self.device = dtype, torch.device(device)
        self.rob_verts = torch.as_tensor(np.asarray(rv, np.float64), dtype=dtype, device=device)
        self.rob_tris = torch.as_tensor(np.asarray(rt, np.int64), device=device)
        obs = np.asarray(ov, np.float64)[np.asarray(ot)]  # [To, 3, 3]
        obs = torch.as_tensor(obs[morton_order(obs.mean(axis=1))], dtype=dtype, device=device)
        self.obs = obs
        self.obs_lo, self.obs_hi = _boxes(obs)
        pad = -len(obs) % BLOCK
        lo = torch.cat([self.obs_lo, self.obs_lo[:1].expand(pad, 3)])
        hi = torch.cat([self.obs_hi, self.obs_hi[:1].expand(pad, 3)])
        self.group_lo, self.group_hi = _pooled(lo, hi, GROUP)
        self.block_lo, self.block_hi = _pooled(lo, hi, BLOCK)
        self.mesh_lo, self.mesh_hi = self.obs_lo.amin(dim=0), self.obs_hi.amax(dim=0)

    def check(self, confs: np.ndarray, rows_per_step: int = 64):
        """(valid [B] bool, box-overlapping pairs [B] int64, robot box meets
        the obstacle box [B] bool) of the [B, 6] configurations, as numpy:
        `MeshPair.check`'s columns."""
        confs_t = torch.as_tensor(np.asarray(confs, np.float64), dtype=self.dtype,
                                  device=self.device)
        out = [self._block(confs_t[lo:lo + rows_per_step])
               for lo in range(0, len(confs_t), rows_per_step)]
        return tuple(torch.cat(col).cpu().numpy() for col in zip(*out))

    def _block(self, confs):
        b, dev = len(confs), self.device
        tri = posed(confs, self.rob_verts)[:, self.rob_tris]  # [b, Tr, 3, 3]
        lo, hi = _boxes(tri)  # [b, Tr, 3]
        row_lo, row_hi = lo.amin(1), hi.amax(1)
        broad = _meets(row_lo, row_hi, self.mesh_lo, self.mesh_hi)
        # 1. Row box x block box.
        rb = _meets(row_lo[:, None], row_hi[:, None], self.block_lo, self.block_hi)
        row, blk = (rb & broad[:, None]).nonzero(as_tuple=True)
        # 2. Robot triangle x the row's surviving blocks.
        tb = _meets(lo[row], hi[row], self.block_lo[blk, None], self.block_hi[blk, None])
        k, rt = tb.nonzero(as_tuple=True)
        row, blk = row[k], blk[k]
        hits = torch.zeros(b, dtype=torch.bool, device=dev)
        pairs = torch.zeros(b, dtype=torch.int64, device=dev)
        per_block, to = BLOCK // GROUP, len(self.obs)
        step = max(1, STEP_PAIRS // per_block)
        for s in range(0, len(row), step):
            # 3. x the groups of the block it meets.
            r, i, g = row[s:s + step], rt[s:s + step], blk[s:s + step]
            g = (g[:, None] * per_block + torch.arange(per_block, device=dev)).reshape(-1)
            r, i = r.repeat_interleave(per_block), i.repeat_interleave(per_block)
            keep = _meets(lo[r, i], hi[r, i], self.group_lo[g], self.group_hi[g])
            r, i, g = r[keep], i[keep], g[keep]
            # 4. x each member.
            j = (g[:, None] * GROUP + torch.arange(GROUP, device=dev)).reshape(-1)
            r, i = r.repeat_interleave(GROUP), i.repeat_interleave(GROUP)
            real = j < to
            r, i, j = r[real], i[real], j[real]
            keep = _meets(lo[r, i], hi[r, i], self.obs_lo[j], self.obs_hi[j])
            r, i, j = r[keep], i[keep], j[keep]
            pairs += torch.bincount(r, minlength=b)
            for t in range(0, len(r), STEP_PAIRS):
                rr, ii, jj = r[t:t + STEP_PAIRS], i[t:t + STEP_PAIRS], j[t:t + STEP_PAIRS]
                hit = pairs_intersect(tri[rr, ii], self.obs[jj])
                hits[rr[hit]] = True
        return ~hits, pairs, broad
