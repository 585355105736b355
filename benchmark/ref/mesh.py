"""Meshes and poses for the plain references, read from the raw files.

Nothing here comes from the program: the OBJ file is parsed anew, the
rotation is written out from its definition (R = Rz(yaw) Ry(pitch) Rx(roll),
columns x y z pitch yaw roll, as the reference's `Utils.cu:88-100`), and the
refined robot's vertices are derived again by midpoint subdivision.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def read_obj(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """(vertices [V, 3] float32, triangles [T, 3] int64) of a Wavefront OBJ
    file: `v` lines, `f` lines fan-triangulated, 1-based `v/vt/vn` indices."""
    verts, tris = [], []
    for line in Path(path).read_text().splitlines():
        if line.startswith("v "):
            verts.append([float(x) for x in line.split()[1:4]])
        elif line.startswith("f "):
            idx = [int(p.split("/")[0]) - 1 for p in line.split()[1:]]
            tris += [(idx[0], idx[k], idx[k + 1]) for k in range(1, len(idx) - 1)]
    return np.asarray(verts, dtype=np.float32), np.asarray(tris, dtype=np.int64)


def subdivided_vertices(verts: np.ndarray, tris: np.ndarray, levels: int) -> np.ndarray:
    """The vertex set after ``levels`` rounds of 1 -> 4 midpoint subdivision
    (no smoothing), each round's new vertices rounded to float32: every
    vertex and the midpoint of every edge, an edge being an unordered pair
    of vertex indices."""
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
    return v


def rotations(confs: torch.Tensor) -> torch.Tensor:
    """[B, 3, 3] rotation of each configuration row (x y z pitch yaw roll),
    R = Rz(yaw) @ Ry(pitch) @ Rx(roll), in the dtype of ``confs``."""
    cb, sb = torch.cos(confs[:, 3]), torch.sin(confs[:, 3])
    ca, sa = torch.cos(confs[:, 4]), torch.sin(confs[:, 4])
    cc, sc = torch.cos(confs[:, 5]), torch.sin(confs[:, 5])
    rows = [ca * cb, ca * sb * sc - sa * cc, ca * sb * cc + sa * sc,
            sa * cb, sa * sb * sc + ca * cc, sa * sb * cc - ca * sc,
            -sb, cb * sc, cb * cc]
    return torch.stack(rows, dim=1).reshape(-1, 3, 3)


def posed(confs: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """[B, P, 3] points [P, 3] posed by each configuration: R p + t."""
    rot = rotations(confs)
    return torch.einsum("bij,pj->bpi", rot, points) + confs[:, None, 0:3]


def morton_order(points: np.ndarray) -> np.ndarray:
    """Indices of [n, 3] points in Morton order over their box, 10 bits an
    axis."""
    lo, hi = points.min(axis=0), points.max(axis=0)
    q = ((points - lo) / np.maximum(hi - lo, 1e-30) * 1023).astype(np.int64)
    code = np.zeros(len(points), dtype=np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return np.argsort(code, kind="stable")
