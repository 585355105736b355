"""Plain clearance that scales with the obstacle: the least distance from any
posed robot point to the obstacle's triangles, per configuration, for
obstacles of tens of thousands of triangles.

The same quantity as `ref/clearance.py`, whose [configurations, points,
groups] box tensor does not fit a card past a few thousand triangles. Here
the points are cut into blocks (Morton order, POINT_BLOCK a block) as the
triangles are into groups, and work is culled in three steps, each only by
a bound that holds in exact arithmetic: a block box's distance to a group
box is at most that of any of its points to any of its triangles, and so is
a point's distance to a group box.

  1. Every (block, group) box distance, per configuration; an upper bound U
     is the least exact distance of the points of the NEAREST (block, group)
     pairs with the closest box centres to their triangles (an attained
     distance: an upper bound whichever pairs are taken).
  2. Each (block, group) pair within U plus a rounding margin: its points
     against the group's box.
  3. Each (point, group) pair within the running best plus the margin: the
     point against the group's triangles (Ericson 5.1.5, as
     `ref/clearance.point_triangle`).

The subdivided obstacle is derived here (`subdivided_mesh`): the topology
and the float32-rounded midpoints of each round. Torch operations only, in
the dtype given (float64 for the reference, float32 for its control), on any
device, in pieces that fit the card; nothing of the program is imported.
"""
from __future__ import annotations

import numpy as np
import torch

from .clearance import point_triangle
from .mesh import morton_order, posed

POINT_BLOCK = 256
GROUP = 16
# (block, group) pairs per configuration whose exact distances give U.
NEAREST = 16
# (block, group) pairs a step takes to their points.
STEP_BLOCKS = 1 << 13
# (point, group) pairs a step takes to their triangles.
STEP_PAIRS = 1 << 17


def subdivided_mesh(verts: np.ndarray, tris: np.ndarray,
                    levels: int) -> tuple[np.ndarray, np.ndarray]:
    """(vertices float32, triangles int64) after ``levels`` rounds of 1 -> 4
    midpoint subdivision (no smoothing): each triangle (a, b, c) becomes
    (a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca), where ab is the
    midpoint of the edge, an unordered pair of vertex indices, computed in
    float64 and rounded to float32 each round."""
    v = np.asarray(verts, dtype=np.float32)
    f = np.asarray(tris, dtype=np.int64)
    for _ in range(levels):
        edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mids = ((v[uniq[:, 0]].astype(np.float64) + v[uniq[:, 1]]) / 2.0).astype(np.float32)
        m = len(v) + inv.reshape(3, -1)
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        ab, bc, ca = m[0], m[1], m[2]
        v = np.concatenate([v, mids])
        f = np.concatenate([np.stack(t, axis=1) for t in
                            ((a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca))])
    return v, f


def _box_d2(lo, hi, glo, ghi):
    """Squared distances between boxes [lo, hi] and [glo, ghi], broadcast."""
    out = 0.0
    for axis in range(3):
        gap = (torch.clamp(glo[..., axis] - hi[..., axis], min=0)
               + torch.clamp(lo[..., axis] - ghi[..., axis], min=0))
        out = out + gap * gap
    return out


class BlockedClearance:
    """Robot points in Morton-ordered blocks and the obstacle's triangles in
    Morton-ordered groups (of their centroids), as tensors of ``dtype`` on
    ``device``. A short last block repeats the last point, a short last
    group the first triangle."""

    def __init__(self, points: np.ndarray, obstacle: tuple, device, dtype=torch.float64):
        ov, ot = obstacle
        self.dtype, self.device = dtype, torch.device(device)
        pts = np.asarray(points, np.float64)
        pts = pts[morton_order(pts)]
        pts = np.concatenate([pts, np.repeat(pts[-1:], -len(pts) % POINT_BLOCK, axis=0)])
        self.points = torch.as_tensor(pts, dtype=dtype, device=device)
        tri = np.asarray(ov, np.float64)[np.asarray(ot)]  # [T, 3, 3]
        tri = tri[morton_order(tri.mean(axis=1))]
        tri = np.concatenate([tri, np.repeat(tri[:1], -len(tri) % GROUP, axis=0)])
        self.tri = torch.as_tensor(tri, dtype=dtype, device=device)
        g = self.tri.reshape(-1, GROUP, 3, 3)
        self.glo = g.amin(dim=(1, 2))
        self.ghi = g.amax(dim=(1, 2))
        self.scale = float(np.abs(tri).max() + np.sqrt((pts ** 2).sum(1)).max())

    def distances(self, confs: np.ndarray, per_step: int = 4) -> np.ndarray:
        """[B] least point-triangle distance of each configuration, numpy
        float64, ``per_step`` configurations at a time."""
        c = torch.as_tensor(np.asarray(confs, np.float64), dtype=self.dtype, device=self.device)
        return np.concatenate([self._some(c[i:i + per_step]).double().cpu().numpy()
                               for i in range(0, len(c), per_step)])

    def _some(self, conf) -> torch.Tensor:
        q, ng = len(conf), len(self.glo)
        p = posed(conf, self.points).reshape(q, -1, POINT_BLOCK, 3)  # [q, nb, PB, 3]
        blo, bhi = p.amin(dim=2), p.amax(dim=2)
        lb = _box_d2(blo[:, :, None], bhi[:, :, None], self.glo, self.ghi).sqrt()  # [q, nb, ng]
        centres = torch.cdist((blo + bhi) / 2, ((self.glo + self.ghi) / 2)[None])
        near = centres.reshape(q, -1).topk(min(NEAREST, lb[0].numel()), largest=False).indices
        blk, grp = near // ng, near % ng  # [q, NEAREST]
        pts = p[torch.arange(q, device=self.device)[:, None], blk]  # [q, NEAREST, PB, 3]
        tri = self.tri.reshape(ng, GROUP, 3, 3)[grp]  # [q, NEAREST, GROUP, 3, 3]
        best = point_triangle(pts[:, :, :, None, :], *(tri[:, :, None, :, k] for k in range(3)))
        best = best.amin(dim=(1, 2, 3))  # [q]: U
        slack = 1e-9 * (self.scale + conf[:, 0:3].abs().amax(dim=1))
        cfg, blk, grp = (lb <= (best + slack)[:, None, None]).nonzero(as_tuple=True)
        order = lb[cfg, blk, grp].argsort()  # nearest first: best falls early
        cfg, blk, grp = cfg[order], blk[order], grp[order]
        for s in range(0, len(cfg), STEP_BLOCKS):
            c, b, g = cfg[s:s + STEP_BLOCKS], blk[s:s + STEP_BLOCKS], grp[s:s + STEP_BLOCKS]
            pp = p[c, b]  # [n, PB, 3]
            pd = _box_d2(pp, pp, self.glo[g, None], self.ghi[g, None]).sqrt()  # [n, PB]
            pair, pt = (pd <= (best + slack)[c, None]).nonzero(as_tuple=True)
            for t in range(0, len(pair), STEP_PAIRS):
                k = pair[t:t + STEP_PAIRS]
                idx = (g[k, None] * GROUP + torch.arange(GROUP, device=self.device)).reshape(-1)
                qp = pp[k, pt[t:t + STEP_PAIRS]].repeat_interleave(GROUP, dim=0)
                d = point_triangle(qp, self.tri[idx, 0], self.tri[idx, 1], self.tri[idx, 2])
                best = best.scatter_reduce(0, c[k].repeat_interleave(GROUP), d, "amin")
        return best
