"""Parasol motion-planning asset formats (.env / .query); a copy of
`robocheck_tpu.io.parasol`.

The reference ships `models/alpha1.0/alpha.env` and `alpha.query` (start/goal
configurations of the alpha-puzzle benchmark) but no code ever reads them
(SURVEY.md L0); this parser makes them usable by the planner layer.

Formats (as present in the alpha1.0 assets):
  .query — one configuration per line: ``index x y z rx ry rz`` where the
           rotation triple is in fractions of a full turn (Parasol/OBPRM
           convention, values in [0,1]); converted here to radians and mapped
           to this framework's (pitch, yaw, roll) = (2*pi*ry, 2*pi*rz,
           2*pi*rx) fixed-frame convention.
  .env   — ``Boundary Box [x0:x1 ; y0:y1 ; z0:z1]`` plus Multibodies
           sections listing active (robot) and passive (obstacle) bodies
           with their mesh files.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import numpy as np


def read_query(path) -> np.ndarray:
    """Parse a .query file -> [N, 6] configurations (x,y,z,pitch,yaw,roll)."""
    confs = []
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if len(parts) < 7:
            continue
        x, y, z = (float(v) for v in parts[1:4])
        rx, ry, rz = (float(v) for v in parts[4:7])
        two_pi = 2.0 * np.pi
        confs.append([x, y, z, two_pi * ry, two_pi * rz, two_pi * rx])
    return np.asarray(confs, dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class Environment:
    boundary: np.ndarray  # [6]: (xmin, ymin, zmin, xmax, ymax, zmax)
    active_meshes: tuple[str, ...]  # robot mesh filenames
    passive_meshes: tuple[str, ...]  # obstacle mesh filenames


def read_env(path) -> Environment:
    text = Path(path).read_text()
    m = re.search(
        r"Boundary Box \[([-\d.eE+]+):([-\d.eE+]+)\s*;\s*"
        r"([-\d.eE+]+):([-\d.eE+]+)\s*;\s*([-\d.eE+]+):([-\d.eE+]+)\]",
        text,
    )
    if not m:
        raise ValueError(f"no Boundary Box in {path}")
    x0, x1, y0, y1, z0, z1 = (float(g) for g in m.groups())
    boundary = np.asarray([x0, y0, z0, x1, y1, z1], dtype=np.float32)

    active: list[str] = []
    passive: list[str] = []
    section = None
    for line in text.splitlines():
        s = line.strip()
        if s == "Active":
            section = active
            continue
        if s == "Passive":
            section = passive
            continue
        if section is not None and (".obj" in s or ".g" in s):
            section.append(s.split()[0])
    return Environment(boundary, tuple(active), tuple(passive))
