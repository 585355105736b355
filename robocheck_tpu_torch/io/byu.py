"""BYU / Parasol ``.g`` mesh format (a copy of `robocheck_tpu.io.byu`).

Replaces the reference's (broken-as-checked-in) CGAL loader
(`models/BYU_Model_Loader.cpp`) and the one-off `models/byu-to-obj.cpp`
converter that originally produced the alpha-puzzle OBJ files.

Format: header ``numParts numVerts numPolys numEdges``; per part a
``startPoly endPoly`` range (1-based); then ``numVerts`` xyz triples; then
polygon lines of 1-based vertex indices where the final index is negated as
a terminator. Polygons triangulate as fans.
"""
from __future__ import annotations

import os

import numpy as np

from ..core.types import Mesh
from .obj import save_obj


def load_byu(path, name: str | None = None) -> Mesh:
    with open(path, "r") as f:
        tokens = f.read().split()
    it = iter(tokens)

    def nxt() -> str:
        return next(it)

    num_parts = int(nxt())
    num_verts = int(nxt())
    num_polys = int(nxt())
    _num_edges = int(nxt())

    for _ in range(num_parts):
        nxt(), nxt()  # per-part polygon ranges (unused: fan over all polys)

    verts = np.empty((num_verts, 3), dtype=np.float32)
    for i in range(num_verts):
        verts[i] = (float(nxt()), float(nxt()), float(nxt()))

    tris: list[tuple[int, int, int]] = []
    for _ in range(num_polys):
        poly: list[int] = []
        while True:
            v = int(nxt())
            if v < 0:
                poly.append(-v - 1)
                break
            poly.append(v - 1)
        for k in range(1, len(poly) - 1):
            tris.append((poly[0], poly[k], poly[k + 1]))

    return Mesh(
        verts,
        np.asarray(tris, dtype=np.int32),
        name or os.path.splitext(os.path.basename(str(path)))[0],
    )


def byu_to_obj(byu_path, obj_path) -> Mesh:
    """The `byu-to-obj` converter as a function."""
    mesh = load_byu(byu_path)
    save_obj(mesh, obj_path)
    return mesh
