"""Plain collision verdicts: a posed robot mesh against a fixed obstacle mesh.

A configuration collides when some robot triangle and some obstacle
triangle intersect (surface contact; a mesh inside the other without
contact is not a collision, as FCL's mesh-mesh ``collide`` reports it).
Each pair is decided by Moller's interval test with exact predicates (no
tolerance band) and a 2-D path for coplanar pairs, in the dtype given:
float64 for the reference, float32 for its control.

Pairs are culled by boxes only: a robot triangle against the boxes of
groups of obstacle triangles, then against each member's box. The count of
box-overlapping pairs of each row is returned beside the verdicts: the pair
work any box-culling sweep has to do (`benchmark/harness/work.py`).
Torch operations only, on any device; nothing of the program is imported.
"""
from __future__ import annotations

import numpy as np
import torch

from .mesh import morton_order, posed

# Obstacle triangles per group box, the triangles in Morton order of their
# centroids (any order is sound; a compact one culls more).
GROUP = 8
# Candidate (row, robot triangle, obstacle triangle) triples a step holds.
STEP_PAIRS = 1 << 23


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _plane_dists(tri, other):
    """Signed distances [n, 3] of ``other``'s corners from ``tri``'s plane
    (unnormalised), and that plane's normal [n, 3]."""
    n = _cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    d = _dot(n[:, None, :], other - tri[:, None, 0]).reshape(-1, 3)
    return d, n


def _interval(p, d):
    """[n, 2] sorted interval where a triangle crosses the other's plane on
    the projected intersection line: p [n, 3] corner projections, d [n, 3]
    signed distances, not all of one strict sign and not all zero. The
    corner alone on its side is found as in Moller's ``COMPUTE_INTERVALS``."""
    d0, d1, d2 = d[:, 0], d[:, 1], d[:, 2]
    alone = torch.where(d0 * d1 > 0, 2,
                        torch.where(d0 * d2 > 0, 1,
                                    torch.where((d1 * d2 > 0) | (d0 != 0), 0,
                                                torch.where(d1 != 0, 1, 2))))
    i0 = alone[:, None]
    i1 = ((alone + 1) % 3)[:, None]
    i2 = ((alone + 2) % 3)[:, None]
    pa, pb, pc = (p.gather(1, i).squeeze(1) for i in (i0, i1, i2))
    da, db, dc = (d.gather(1, i).squeeze(1) for i in (i0, i1, i2))
    ta = pa + (pb - pa) * (da / (da - db))
    tb = pa + (pc - pa) * (da / (da - dc))
    return torch.stack([torch.minimum(ta, tb), torch.maximum(ta, tb)], dim=1)


def _orient(a, b, c):
    """Twice the signed area of 2-D triangles (a, b, c), [n]."""
    return (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])


def _segments_cross(p, q, r, s):
    """Closed 2-D segments pq and rs meet (collinear overlaps included)."""
    o1, o2 = _orient(p, q, r), _orient(p, q, s)
    o3, o4 = _orient(r, s, p), _orient(r, s, q)
    proper = (o1 * o2 <= 0) & (o3 * o4 <= 0)

    def on(a, b, x):  # x within a-b's box (used where collinear)
        return ((torch.minimum(a[:, 0], b[:, 0]) <= x[:, 0]) & (x[:, 0] <= torch.maximum(a[:, 0], b[:, 0]))
                & (torch.minimum(a[:, 1], b[:, 1]) <= x[:, 1]) & (x[:, 1] <= torch.maximum(a[:, 1], b[:, 1])))

    collinear = (o1 == 0) & (o2 == 0)
    overlap = on(p, q, r) | on(p, q, s) | on(r, s, p) | on(r, s, q)
    return torch.where(collinear, overlap, proper)


def _inside(pt, tri):
    """2-D point [n, 2] in the closed triangle [n, 3, 2]."""
    e = [_orient(tri[:, k], tri[:, (k + 1) % 3], pt) for k in range(3)]
    return ((e[0] >= 0) & (e[1] >= 0) & (e[2] >= 0)) | ((e[0] <= 0) & (e[1] <= 0) & (e[2] <= 0))


def _coplanar(t1, t2, n1):
    """Coplanar pairs: projected onto the plane of the normal's two smaller
    axes, an edge of one crosses an edge of the other, or one contains a
    corner of the other."""
    drop = n1.abs().argmax(dim=1)
    keep = torch.stack([(drop + 1) % 3, (drop + 2) % 3], dim=1).sort(dim=1).values
    idx = keep[:, None, :].expand(-1, 3, -1)
    a, b = t1.gather(2, idx), t2.gather(2, idx)
    hit = _inside(a[:, 0], b) | _inside(b[:, 0], a)
    for i in range(3):
        for j in range(3):
            hit |= _segments_cross(a[:, i], a[:, (i + 1) % 3], b[:, j], b[:, (j + 1) % 3])
    return hit


def pairs_intersect(t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    """[n] bool: triangles t1 [n, 3, 3] and t2 [n, 3, 3] intersect."""
    d1, n2 = _plane_dists(t2, t1)  # t1's corners against t2's plane
    d2, n1 = _plane_dists(t1, t2)
    apart = (((d1 > 0).all(1) | (d1 < 0).all(1)) | ((d2 > 0).all(1) | (d2 < 0).all(1)))
    flat = (d1 == 0).all(1)
    axis = _cross(n1, n2).abs().argmax(dim=1)[:, None, None].expand(-1, 3, 1)
    p1, p2 = t1.gather(2, axis).squeeze(2), t2.gather(2, axis).squeeze(2)
    live = ~apart & ~flat
    hit = torch.zeros_like(apart)
    if live.any():
        i1, i2 = _interval(p1[live], d1[live]), _interval(p2[live], d2[live])
        hit[live] = (i1[:, 0] <= i2[:, 1]) & (i2[:, 0] <= i1[:, 1])
    cop = ~apart & flat
    if cop.any():
        hit[cop] = _coplanar(t1[cop], t2[cop], n1[cop])
    return hit


def _boxes(tri):
    return tri.amin(dim=-2), tri.amax(dim=-2)


def _meets(lo1, hi1, lo2, hi2):
    return ((lo1 <= hi2) & (lo2 <= hi1)).all(dim=-1)


class MeshPair:
    """The robot's triangles (rest frame) and the obstacle's, with the
    obstacle's group boxes, as tensors of ``dtype`` on ``device``."""

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
        pad = -len(obs) % GROUP
        lo = torch.cat([self.obs_lo, self.obs_lo[:1].expand(pad, 3)])
        hi = torch.cat([self.obs_hi, self.obs_hi[:1].expand(pad, 3)])
        self.group_lo = lo.reshape(-1, GROUP, 3).amin(dim=1)
        self.group_hi = hi.reshape(-1, GROUP, 3).amax(dim=1)
        self.mesh_lo, self.mesh_hi = self.obs_lo.amin(dim=0), self.obs_hi.amax(dim=0)

    def check(self, confs: np.ndarray, rows_per_step: int = 64):
        """(valid [B] bool, box-overlapping pairs [B] int64, robot box meets
        the obstacle box [B] bool) of the [B, 6] configurations, as numpy."""
        confs_t = torch.as_tensor(np.asarray(confs, np.float64), dtype=self.dtype,
                                  device=self.device)
        out = [self._block(confs_t[lo:lo + rows_per_step])
               for lo in range(0, len(confs_t), rows_per_step)]
        return tuple(torch.cat(col).cpu().numpy() for col in zip(*out))

    def _block(self, confs):
        b = len(confs)
        tri = posed(confs, self.rob_verts)[:, self.rob_tris]  # [b, Tr, 3, 3]
        lo, hi = _boxes(tri)  # [b, Tr, 3]
        broad = _meets(lo.amin(1), hi.amax(1), self.mesh_lo, self.mesh_hi)
        # Robot triangle x obstacle group, then x each member.
        rg = _meets(lo[:, :, None], hi[:, :, None], self.group_lo, self.group_hi)
        rg &= broad[:, None, None]
        row, rt, grp = rg.nonzero(as_tuple=True)
        hits = torch.zeros(b, dtype=torch.bool, device=self.device)
        pairs = torch.zeros(b, dtype=torch.int64, device=self.device)
        to = len(self.obs)
        step = max(1, STEP_PAIRS // GROUP)
        for s in range(0, len(row), step):
            r, i, g = row[s:s + step], rt[s:s + step], grp[s:s + step]
            j = (g[:, None] * GROUP + torch.arange(GROUP, device=self.device)).reshape(-1)
            r, i = r.repeat_interleave(GROUP), i.repeat_interleave(GROUP)
            real = j < to
            r, i, j = r[real], i[real], j[real]
            keep = _meets(lo[r, i], hi[r, i], self.obs_lo[j], self.obs_hi[j])
            r, i, j = r[keep], i[keep], j[keep]
            pairs += torch.bincount(r, minlength=b)
            hit = pairs_intersect(tri[r, i], self.obs[j])
            hits[r[hit]] = True
        return ~hits, pairs, broad
