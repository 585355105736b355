"""Plain clearance: the least distance from any posed robot point to the
obstacle's triangles, per configuration.

Each point-triangle distance is the distance to the triangle's closest
point, found by the region tests of Ericson, Real-Time Collision Detection
5.1.5, in the dtype given: float64 for the reference, float32 for its
control. Work is culled only by bounds that hold in exact arithmetic: a
point's distance to a group box of obstacle triangles is at most its
distance to any member, and an upper bound U is the least exact distance of
a few points; a (point, group) pair whose box distance exceeds U by more
than a rounding margin cannot hold the minimum. Torch operations only, on
any device; nothing of the program is imported.
"""
from __future__ import annotations

import numpy as np
import torch

from .mesh import morton_order, posed

GROUP = 16
# Points per configuration measured against every triangle for U.
PROBES = 256
# Point-group pairs a step expands to their triangles.
STEP_PAIRS = 1 << 17


def _dot(a, b):
    return (a * b).sum(-1)


def point_triangle(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor) -> torch.Tensor:
    """Distances [...] from points p to triangles (a, b, c), all [..., 3]."""
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    bp = p - b
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    cp = p - c
    d5, d6 = _dot(ab, cp), _dot(ac, cp)
    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4
    denom = va + vb + vc
    q = a + ab * (vb / denom)[..., None] + ac * (vc / denom)[..., None]  # the face
    steps = [  # later tests take precedence, as Ericson's early returns
        ((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
         lambda: b + (c - b) * ((d4 - d3) / ((d4 - d3) + (d5 - d6)))[..., None]),
        ((vb <= 0) & (d2 >= 0) & (d6 <= 0), lambda: a + ac * (d2 / (d2 - d6))[..., None]),
        ((d6 >= 0) & (d5 <= d6), lambda: c),
        ((vc <= 0) & (d1 >= 0) & (d3 <= 0), lambda: a + ab * (d1 / (d1 - d3))[..., None]),
        ((d3 >= 0) & (d4 <= d3), lambda: b),
        ((d1 <= 0) & (d2 <= 0), lambda: a),
    ]
    for cond, point in steps:
        q = torch.where(cond[..., None], point().expand_as(q), q)
    return torch.linalg.vector_norm(p - q, dim=-1)


def _box_dist(p, lo, hi):
    gap = torch.clamp(lo - p, min=0) + torch.clamp(p - hi, min=0)
    return torch.linalg.vector_norm(gap, dim=-1)


class Clearance:
    """Robot points (rest frame) and the obstacle's triangles in groups (in
    Morton order of their centroids), as tensors of ``dtype`` on
    ``device``."""

    def __init__(self, points: np.ndarray, obstacle: tuple, device, dtype=torch.float64):
        ov, ot = obstacle
        self.dtype, self.device = dtype, torch.device(device)
        self.points = torch.as_tensor(np.asarray(points, np.float64), dtype=dtype, device=device)
        tri = np.asarray(ov, np.float64)[np.asarray(ot)]  # [T, 3, 3]
        tri = tri[morton_order(tri.mean(axis=1))]
        pad = -len(tri) % GROUP
        tri = np.concatenate([tri, np.repeat(tri[:1], pad, axis=0)])
        self.tri = torch.as_tensor(tri, dtype=dtype, device=device)
        g = self.tri.reshape(-1, GROUP, 3, 3)
        self.glo = g.amin(dim=(1, 2))
        self.ghi = g.amax(dim=(1, 2))
        self.scale = float(np.abs(tri).max() + np.sqrt((np.asarray(points, np.float64) ** 2)
                                                       .sum(1)).max())

    def distances(self, confs: np.ndarray, per_step: int = 8) -> np.ndarray:
        """[B] least point-triangle distance of each configuration, numpy
        float64, ``per_step`` configurations at a time."""
        c = torch.as_tensor(np.asarray(confs, np.float64), dtype=self.dtype, device=self.device)
        return np.concatenate([self._some(c[i:i + per_step]).double().cpu().numpy()
                               for i in range(0, len(c), per_step)])

    def _some(self, conf) -> torch.Tensor:
        q = len(conf)
        p = posed(conf, self.points)  # [q, N, 3]
        lb = _box_dist(p[:, :, None, :], self.glo, self.ghi)  # [q, N, G]
        probe = lb.amin(dim=2).topk(min(PROBES, p.shape[1]), largest=False).indices  # [q, K]
        pp = p.gather(1, probe[..., None].expand(-1, -1, 3))
        a, b, c = self.tri[:, 0], self.tri[:, 1], self.tri[:, 2]
        u = point_triangle(pp[:, :, None, :], a, b, c).amin(dim=2).amin(dim=1)  # [q]
        slack = 1e-9 * (self.scale + conf[:, 0:3].abs().amax(dim=1))
        cfg, pt, grp = (lb <= (u + slack)[:, None, None]).nonzero(as_tuple=True)
        best = u.clone()
        for s in range(0, len(pt), STEP_PAIRS):
            tri = (grp[s:s + STEP_PAIRS, None] * GROUP
                   + torch.arange(GROUP, device=self.device)).reshape(-1)
            qp = p[cfg[s:s + STEP_PAIRS], pt[s:s + STEP_PAIRS]].repeat_interleave(GROUP, dim=0)
            d = point_triangle(qp, a[tri], b[tri], c[tri])
            best = best.scatter_reduce(0, cfg[s:s + STEP_PAIRS].repeat_interleave(GROUP), d,
                                       "amin")
        return best
