"""The plain references against the reference's own tags and by hand."""
from pathlib import Path

import numpy as np
import pytest
import torch

from ref.clearance import Clearance, point_triangle
from ref.mesh import read_obj, subdivided_vertices
from ref.tritri import MeshPair, pairs_intersect
from conftest import BENCH, ROOT

ROBOT = read_obj(BENCH / "data/alpha1.0/robot.obj")
OBSTACLE = read_obj(BENCH / "data/alpha1.0/obstacle.obj")


def _tagged(path: Path, n: int):
    rows = np.array([[float(x) for x in line.split()]
                     for line in path.read_text().splitlines()[1:n + 1]])
    return rows[:, :6].astype(np.float32), rows[:, 6].astype(bool)


def test_verdicts_equal_the_fcl_tags():
    """The first 32 rows of the reference's tagged 10k sets (FCL's verdicts)."""
    pair = MeshPair(ROBOT, OBSTACLE, "cpu")
    for name in ("hard_confs10,000.conf", "easy_confs10,000.conf"):
        confs, tags = _tagged(ROOT / "data" / name, 32)
        valid, pairs, broad = pair.check(confs)
        assert (valid == tags).all(), name
        assert (pairs[~broad] == 0).all()


def test_pair_test_by_hand():
    t = torch.tensor([[0, 0, 0], [1, 0, 0], [0, 1, 0]], dtype=torch.float64)
    cases = [  # (second triangle, intersects)
        ([[0.2, 0.2, -1], [0.2, 0.2, 1], [0.3, 0.3, 1]], True),  # pierces
        ([[0.2, 0.2, 0.1], [0.2, 0.3, 1], [0.3, 0.3, 1]], False),  # above
        ([[2, 2, -1], [2, 2, 1], [3, 3, 1]], False),  # crosses the plane outside
        ([[0.1, 0.1, 0], [0.5, 0.1, 0], [0.1, 0.5, 0]], True),  # coplanar, inside
        ([[2, 0, 0], [3, 0, 0], [2, 1, 0]], False),  # coplanar, apart
        ([[0.5, -0.5, 0], [0.5, 0.5, 0], [1.5, 0, 0]], True),  # coplanar, edges cross
    ]
    other = torch.tensor([c for c, _ in cases], dtype=torch.float64)
    got = pairs_intersect(t.expand(len(cases), 3, 3), other)
    assert got.tolist() == [hit for _, hit in cases]
    assert pairs_intersect(other, t.expand(len(cases), 3, 3)).tolist() == got.tolist()


def test_point_triangle_distances_by_hand():
    a, b, c = (torch.tensor(v, dtype=torch.float64) for v in ([0, 0, 0], [2, 0, 0], [0, 2, 0]))
    points = torch.tensor([[0.5, 0.5, 3], [-1, -1, 0], [3, 0, 1], [1, -2, 0], [2, 2, 0],
                           [-1, 1, 0], [0.5, 0.5, 0]], dtype=torch.float64)
    want = [3, 2 ** 0.5, 2 ** 0.5, 2, 2 ** 0.5, 1, 0]
    got = point_triangle(points, a.expand(7, 3), b.expand(7, 3), c.expand(7, 3))
    assert torch.allclose(got, torch.tensor(want, dtype=torch.float64))


def test_culled_clearance_equals_every_pair():
    """The culled search gives the minimum over every point-triangle pair (to
    float64 rounding: the two pose their points in batches of other sizes)."""
    points = subdivided_vertices(*ROBOT, 1)
    confs = np.array([[20, 5, 3, 0.3, -1.2, 2.0], [0.2, 0.1, 0, 0.1, 0.2, 0.3]], np.float32)
    got = Clearance(points, OBSTACLE, "cpu").distances(confs)
    tri = torch.as_tensor(OBSTACLE[0].astype(np.float64)[OBSTACLE[1]])
    from ref.mesh import posed
    for i, conf in enumerate(confs):
        p = posed(torch.as_tensor(conf[None].astype(np.float64)), torch.as_tensor(
            points.astype(np.float64)))[0]
        full = min(float(point_triangle(p[lo:lo + 512, None], tri[:, 0], tri[:, 1],
                                        tri[:, 2]).min()) for lo in range(0, len(p), 512))
        assert got[i] == pytest.approx(full, rel=1e-12, abs=0)


def test_subdivision_gives_the_programs_points():
    from robocheck_tpu_torch import load_obj
    from robocheck_tpu_torch.planner.ccd import subdivide_mesh

    ours = subdivided_vertices(*ROBOT, 2)
    theirs = subdivide_mesh(load_obj(BENCH / "data/alpha1.0/robot.obj"), 2).vertices
    assert (np.unique(ours, axis=0) == np.unique(theirs, axis=0)).all()
