"""Wavefront OBJ mesh loading.

Equivalent of the reference loader (`Utils_rai.cu:139-226` AoS /
`Utils_rai.cu:228-320` SoA): vertices (``v`` lines), triangulated faces
(``f`` lines, fan triangulation for polygons, 1-based indices, ``v/vt/vn``
forms accepted, normals/texcoords ignored). There is no AoS/SoA split here —
the array layout decision lives in `core.types`.
"""
from __future__ import annotations

import os

import numpy as np

from ..core.types import Mesh


def load_obj(path: str | os.PathLike, name: str | None = None) -> Mesh:
    vertices: list[tuple[float, float, float]] = []
    triangles: list[tuple[int, int, int]] = []

    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                vertices.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("f "):
                parts = line.split()[1:]
                idx = [int(p.split("/")[0]) - 1 for p in parts]
                # Fan-triangulate polygons (reference does the same,
                # Utils_rai.cu:198-212).
                for k in range(1, len(idx) - 1):
                    triangles.append((idx[0], idx[k], idx[k + 1]))

    if not vertices:
        raise ValueError(f"no vertices found in {path}")
    return Mesh(
        vertices=np.asarray(vertices, dtype=np.float32),
        triangles=np.asarray(triangles, dtype=np.int32),
        name=name or os.path.splitext(os.path.basename(str(path)))[0],
    )


def save_obj(mesh: Mesh, path: str | os.PathLike) -> None:
    with open(path, "w") as f:
        f.write(f"o {mesh.name}\n")
        for v in mesh.vertices:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for t in mesh.triangles:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
