"""Procedural test meshes (synthetic fixtures; the reference's equivalents are
hand-written tetrahedra arrays in `test-narrow-phase.cu:628-686`)."""
from __future__ import annotations

import numpy as np

from ..core.types import Mesh


def tetrahedron(scale: float = 1.0, name: str = "tetra") -> Mesh:
    """The reference's narrow-phase fixture shape (4 faces)."""
    pts = np.array(
        [[0, 0, 0], [0, 1, 2], [0, 2, 0], [2, 2, 2]], dtype=np.float32
    ) * np.float32(scale)
    tris = np.array(
        [[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], dtype=np.int32
    )
    return Mesh(pts, tris, name)


def box(extent=(1.0, 1.0, 1.0), center=(0.0, 0.0, 0.0), name: str = "box") -> Mesh:
    e = np.asarray(extent, np.float32) / 2
    c = np.asarray(center, np.float32)
    corners = np.array(
        [
            [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
            [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
        ],
        np.float32,
    )
    verts = corners * e + c
    quads = [
        (0, 1, 2, 3), (4, 7, 6, 5), (0, 4, 5, 1),
        (1, 5, 6, 2), (2, 6, 7, 3), (3, 7, 4, 0),
    ]
    tris = []
    for (a, b_, c_, d) in quads:
        tris.append((a, b_, c_))
        tris.append((a, c_, d))
    return Mesh(verts, np.asarray(tris, np.int32), name)


def icosphere(subdivisions: int = 1, radius: float = 1.0,
              name: str = "icosphere") -> Mesh:
    """Subdivided icosahedron (20 * 4^n triangles)."""
    phi = (1 + 5 ** 0.5) / 2
    verts = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True)

    for _ in range(subdivisions):
        vlist = list(verts)
        cache: dict[tuple[int, int], int] = {}

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = vlist[a] + vlist[b]
                m = m / np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m)
            return cache[key]

        new_faces = []
        for (a, b, c) in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)

    return Mesh(
        (verts * radius).astype(np.float32), faces.astype(np.int32), name
    )


def triangle_soup(rng: np.random.Generator, num_triangles: int,
                  extent: float = 1.0, name: str = "soup") -> Mesh:
    verts = rng.uniform(-extent, extent, size=(num_triangles * 3, 3)).astype(
        np.float32
    )
    tris = np.arange(num_triangles * 3, dtype=np.int32).reshape(-1, 3)
    return Mesh(verts, tris, name)
