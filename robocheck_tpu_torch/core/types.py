"""Array-first core types (a copy of `robocheck_tpu.core.types`).

The reference models everything as AoS POD structs (`Utils_rai.h:51-96`:
`Configuration`, `Vector3f`, `Triangle`, `AABB`). This design instead uses
dense arrays with a batch-major layout:

  * configurations: float32 ``[N, 6]`` with columns (x, y, z, pitch, yaw, roll)
    — the column order of the ``.conf`` text format (`Utils_rai.cu:67`).
  * mesh vertices:  float32 ``[V, 3]``
  * mesh triangles: int32 ``[T, 3]`` vertex indices
  * AABBs: float32 ``[..., 6]`` with columns (xmin, ymin, zmin, xmax, ymax, zmax)

`Mesh.padded` gives lane-aligned triangle arrays: the triangle count rounded
up to a multiple of 128, the padding triangles degenerate (all three indices
point at vertex 0) and marked False in a validity mask, so the dense
reference pipeline (`ops.pipeline`) masks the tail instead of branching.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

from .constants import LANE, round_up

# Column indices for configuration arrays.
CONF_X, CONF_Y, CONF_Z, CONF_PITCH, CONF_YAW, CONF_ROLL = range(6)

# Column indices for AABB arrays.
AABB_XMIN, AABB_YMIN, AABB_ZMIN, AABB_XMAX, AABB_YMAX, AABB_ZMAX = range(6)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A triangle mesh held as host numpy arrays (the checker builds its
    device tables from it once)."""

    vertices: np.ndarray  # [V, 3] float32
    triangles: np.ndarray  # [T, 3] int32
    name: str = "mesh"

    def __post_init__(self):
        v = np.ascontiguousarray(self.vertices, dtype=np.float32)
        t = np.ascontiguousarray(self.triangles, dtype=np.int32)
        if v.ndim != 2 or v.shape[1] != 3:
            raise ValueError(f"vertices must be [V,3], got {v.shape}")
        if t.ndim != 2 or t.shape[1] != 3:
            raise ValueError(f"triangles must be [T,3], got {t.shape}")
        object.__setattr__(self, "vertices", v)
        object.__setattr__(self, "triangles", t)

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.triangles.shape[0]

    @cached_property
    def aabb(self) -> np.ndarray:
        """Whole-mesh AABB, float32 [6]."""
        lo = self.vertices.min(axis=0)
        hi = self.vertices.max(axis=0)
        return np.concatenate([lo, hi]).astype(np.float32)

    @cached_property
    def triangle_vertices(self) -> np.ndarray:
        """Gathered triangle corners, float32 [T, 3 (corner), 3 (xyz)]."""
        return self.vertices[self.triangles]

    def padded(self, multiple: int = LANE) -> "PaddedMesh":
        return PaddedMesh.from_mesh(self, multiple)

    @staticmethod
    def merge(meshes: "list[Mesh]", name: str = "merged") -> "Mesh":
        """Concatenate meshes into one (multi-obstacle scenes collapse into
        a single obstacle — verdicts are any-hit, so merging is exact)."""
        verts = []
        tris = []
        offset = 0
        for m in meshes:
            verts.append(m.vertices)
            tris.append(m.triangles + offset)
            offset += m.num_vertices
        return Mesh(np.concatenate(verts), np.concatenate(tris), name)

    def transformed(self, conf: np.ndarray) -> "Mesh":
        """A posed copy (float64 math, rounded to f32) — for static obstacle
        placement, e.g. Parasol .env passive-body transforms."""
        from ..oracle.cpu_oracle import transform_vertices_f64

        v = transform_vertices_f64(np.asarray(conf, np.float64), self.vertices)
        return Mesh(v.astype(np.float32), self.triangles, self.name)


@dataclasses.dataclass(frozen=True)
class PaddedMesh:
    """Lane-aligned view of a mesh: the triangle list padded to a multiple of
    ``multiple`` with degenerate triangles, and a validity mask."""

    vertices: np.ndarray  # [V, 3] float32 (unpadded)
    triangles: np.ndarray  # [Tp, 3] int32
    tri_mask: np.ndarray  # [Tp] bool, False on padding
    num_triangles: int  # true triangle count

    @staticmethod
    def from_mesh(mesh: Mesh, multiple: int = LANE) -> "PaddedMesh":
        t = mesh.num_triangles
        tp = round_up(t, multiple)
        tris = np.zeros((tp, 3), dtype=np.int32)
        tris[:t] = mesh.triangles
        mask = np.zeros((tp,), dtype=bool)
        mask[:t] = True
        return PaddedMesh(mesh.vertices, tris, mask, t)

    @cached_property
    def triangle_vertices(self) -> np.ndarray:
        """[Tp, 3, 3] float32; padding rows repeat vertex 0 (degenerate)."""
        return self.vertices[self.triangles]


def validate_confs(confs: np.ndarray) -> np.ndarray:
    c = np.ascontiguousarray(confs, dtype=np.float32)
    if c.ndim != 2 or c.shape[1] != 6:
        raise ValueError(f"configurations must be [N,6], got {c.shape}")
    return c
