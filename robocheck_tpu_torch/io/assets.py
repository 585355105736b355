"""Benchmark asset resolution.

The canonical benchmark pair is the Parasol "alpha puzzle 1.0" robot/obstacle
mesh (792 vertices / 1008 triangles each) plus the tagged configuration
datasets. Assets are data, not code; they are looked up, in order, in:

  1. ``$ROBOCHECK_ASSETS`` (a directory containing ``models/alpha1.0`` and
     the ``*.conf`` files),
  2. this repository's ``models/`` + ``data/`` directories (populated by
     ``scripts/fetch_assets.py`` from a reference checkout),
  3. a reference checkout at ``$ROBOCHECK_REFERENCE_DIR``, when set.
"""
from __future__ import annotations

import os
from pathlib import Path

_REPO_ROOT = Path(__file__).resolve().parents[2]

DATASET_FILES = {
    "easy10k": "easy_confs10,000.conf",
    "hard10k": "hard_confs10,000.conf",
    "samples10k": "10,000samples.conf",
    "easy100k": "easy_confs100,000.conf",
    "hard100k": "hard_confs100,000.conf",
}


def _roots() -> list[Path]:
    roots = []
    env = os.environ.get("ROBOCHECK_ASSETS")
    if env:
        roots.append(Path(env))
    roots.append(_REPO_ROOT)
    ref = os.environ.get("ROBOCHECK_REFERENCE_DIR")
    if ref:
        roots.append(Path(ref))
    return roots


def find_asset(rel: str) -> Path:
    """Resolve a relative asset path (e.g. ``models/alpha1.0/robot.obj``)."""
    tried = []
    for root in _roots():
        for cand in (root / rel, root / "data" / rel, root / Path(rel).name):
            if cand.exists():
                return cand
            tried.append(str(cand))
    raise FileNotFoundError(f"asset {rel!r} not found; tried: {tried}")


def alpha_robot_path() -> Path:
    return find_asset("models/alpha1.0/robot.obj")


def alpha_obstacle_path() -> Path:
    return find_asset("models/alpha1.0/obstacle.obj")


# The sets that are not tracked, and the command that makes them (the
# native float64 oracle first: with the NumPy one hard100k takes hours).
UNTRACKED = ("easy100k", "hard100k")
MAKE_UNTRACKED = "make -C native && python3 scripts/torch_make_datasets.py"


def dataset_path(key: str) -> Path:
    """Resolve one of the named benchmark datasets (see DATASET_FILES). A
    missing UNTRACKED set raises FileNotFoundError naming its command."""
    try:
        return find_asset(DATASET_FILES[key])
    except FileNotFoundError as e:
        if key not in UNTRACKED:
            raise
        raise FileNotFoundError(f"{e}; {key} is made by `{MAKE_UNTRACKED}`") from None
